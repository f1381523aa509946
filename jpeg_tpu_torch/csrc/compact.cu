// K2: stream compaction by positioned deposit, rows -> contiguous stream.
//
// Replaces the Pallas kernel jpeg_tpu/ops/pallas_kernels.py
// `_merge_rows_kernel` (wrapper `merge_rows_units`, nine rounds of pairwise
// byte-exact row concatenation) together with the grouped row gather that
// followed it in jpeg_tpu/entropy/device_codec.py `compact_rows`.
//
// What it computes: the (cap,) byte buffer whose bytes are block i's first
// blk_bytes[i] bytes (its stream row from K1, big-endian words; bytes past
// the row's 4*W read as zero) at the exclusive prefix sum of blk_bytes,
// zeros from the sum to cap, and nothing past cap.
//
// What bounds it on this card: data movement, one read of each block's
// bytes of its row and one write of the stream (2.8 MB each way and 0.2 MB
// of block bytes for a 2048x2048 image: 0.0009 ms at 3.35 TB/s), so in
// practice launch latency and the dependent chain from a block's length to
// its bytes' positions.
//
// What the design does about it: two launches and nothing else on the
// device (no memset, cast or separate prefix sum).
// 1. tile_totals_kernel: one thread block per tile of kTileBlocks blocks
//    writes the tile's byte total to status[tile] (an "aggregate").  This
//    also initialises the status words launch 2 reads, so they need no
//    memset.
// 2. deposit_kernel: the thread block of a tile scans its blk_bytes in
//    shared memory (the tile-relative exclusive offsets), then looks back
//    over the status words of the tiles before it, 256 at a time (one a
//    thread, all loads in flight together): it sums aggregates up to the
//    nearest tile that has published its inclusive prefix (kPrefixFlag
//    set) and publishes its own.  No tile waits on another: every
//    aggregate exists before launch 2 starts, so a tile whose neighbours
//    have not published yet reads further back instead.  The
//    tile's bytes [base, base + total) are then written by output word:
//    thread k takes aligned 32-bit words k, k + 256, ... of the range,
//    finds the block holding each word's first byte by binary search over
//    the tile's offsets, assembles the word from one or two row words with
//    a funnel shift (and from the next blocks where the block ends inside
//    it), and stores it whole, so neighbouring threads write neighbouring
//    words.  The at most three bytes before the range's first aligned word
//    and after its last are stored one by one, so every output byte has
//    exactly one writer.  The last tile also writes the zero tail [total,
//    cap).  Work follows the stream's bytes, not the rows' width W, and no
//    thread divides.
#include "common.cuh"

namespace {

constexpr int kTileBlocks = 256;                 // blocks a tile, one a thread
constexpr int kThreads = kTileBlocks;
constexpr int kWarps = kThreads / 32;
constexpr uint64_t kPrefixFlag = 1ull << 62;     // status: inclusive prefix
constexpr uint64_t kValueMask = kPrefixFlag - 1;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int64_t warp_sum(int64_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    tile_totals_kernel(const int32_t* __restrict__ blk_bytes, int64_t n,
                       uint64_t* __restrict__ status) {
  __shared__ int64_t part[kWarps];
  const int64_t i = int64_t(blockIdx.x) * kTileBlocks + threadIdx.x;
  const int64_t v = warp_sum(i < n ? blk_bytes[i] : 0);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int64_t total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += part[w];
    status[blockIdx.x] = static_cast<uint64_t>(total);
  }
}

struct Tile {
  const uint32_t* __restrict__ rows;   // the tile's first block's row
  const int64_t* off;                  // shared: kTileBlocks + 1 offsets
  int W;

  // The block holding tile-relative byte p < off[kTileBlocks]: the last
  // j with off[j] <= p (empty blocks before it share its offset).
  __device__ int block_of(int64_t p) const {
    int lo = 0, hi = kTileBlocks - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (off[mid] <= p) lo = mid; else hi = mid - 1;
    }
    return lo;
  }

  __device__ uint32_t row_word(int j, int64_t wi) const {
    return wi < W ? rows[int64_t(j) * W + wi] : 0u;
  }

  __device__ uint32_t byte_at(int64_t p) const {
    const int j = block_of(p);
    const int64_t q = p - off[j];
    return (row_word(j, q >> 2) >> (24 - 8 * (q & 3))) & 0xffu;
  }

  // The 4 bytes from tile-relative byte p on (all inside the tile's
  // range), most significant first.
  __device__ uint32_t word_at(int64_t p) const {
    int j = block_of(p);
    int64_t q = p - off[j];
    uint32_t word = 0;
    int have = 0;
    while (true) {
      const int64_t left = off[j + 1] - off[j] - q;
      const int take = left < 4 - have ? static_cast<int>(left) : 4 - have;
      if (take > 0) {
        const int64_t wi = q >> 2;
        const int sh = 8 * static_cast<int>(q & 3);
        const uint32_t hi = row_word(j, wi);
        const uint32_t lo = sh ? row_word(j, wi + 1) : 0u;
        const uint32_t v = __funnelshift_l(lo, hi, sh);
        const uint32_t keep = take == 4 ? kFull : ~(kFull >> (8 * take));
        word |= (v & keep) >> (8 * have);
        have += take;
      }
      if (have == 4 || j + 1 >= kTileBlocks) return word;
      ++j;
      q = 0;
    }
  }
};

__device__ __forceinline__ void store_word(uint8_t* out, int64_t w,
                                           uint32_t big_endian) {
  reinterpret_cast<uint32_t*>(out)[w] = __byte_perm(big_endian, 0, 0x0123);
}

__global__ void __launch_bounds__(kThreads)
    deposit_kernel(const uint32_t* __restrict__ rows,
                   const int32_t* __restrict__ blk_bytes, int64_t n, int W,
                   uint8_t* __restrict__ out, int64_t cap,
                   volatile uint64_t* status) {
  __shared__ int64_t off[kTileBlocks + 1];
  __shared__ int64_t part[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t tile = blockIdx.x;
  const int64_t first = tile * kTileBlocks;

  // The tile's exclusive offsets.
  int64_t x = first + tid < n ? blk_bytes[first + tid] : 0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int64_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) part[warp] = x;
  __syncthreads();
  int64_t before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) before += w < warp ? part[w] : 0;
  off[tid + 1] = before + x;
  if (tid == 0) off[0] = 0;
  __syncthreads();
  const int64_t total = off[kTileBlocks];

  // The bytes before the tile: look back over kThreads predecessors a
  // round, thread k reading tile - 1 - k, up to the nearest published
  // prefix; then publish this tile's.
  __shared__ int first_s[kWarps];
  int64_t base = 0;
  for (int64_t j = tile - 1;; j -= kThreads) {
    const int64_t q = j - tid;
    // Before tile 0: a published prefix of 0.
    const uint64_t s = q >= 0 ? uint64_t(status[q]) : uint64_t(kPrefixFlag);
    const unsigned pref = __ballot_sync(kFull, (s & kPrefixFlag) != 0);
    if (lane == 0)
      first_s[warp] = pref ? 32 * warp + __ffs(pref) - 1 : kThreads;
    __syncthreads();
    int stop = kThreads;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) stop = min(stop, first_s[w]);
    const int64_t v = warp_sum(tid <= stop ? int64_t(s & kValueMask) : 0);
    if (lane == 0) part[warp] = v;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) base += part[w];
    if (stop < kThreads) break;
    __syncthreads();                 // part and first_s are reused
  }
  if (tid == 0) status[tile] = kPrefixFlag | static_cast<uint64_t>(base + total);

  const Tile t{rows + first * W, off, W};
  const int64_t end = base + total < cap ? base + total : cap;
  if (base < end) {
    const int64_t wa = (base + 3) >> 2, wb = end >> 2;  // whole words
    if (wa < wb) {
      for (int64_t w = wa + tid; w < wb; w += kThreads)
        store_word(out, w, t.word_at(4 * w - base));
      if (tid < 3) {                                 // bytes before word wa
        const int64_t p = base + tid;
        if (p < 4 * wa) out[p] = static_cast<uint8_t>(t.byte_at(p - base));
      } else if (tid < 6) {                          // bytes after word wb
        const int64_t p = 4 * wb + tid - 3;
        if (p < end) out[p] = static_cast<uint8_t>(t.byte_at(p - base));
      }
    } else {
      for (int64_t p = base + tid; p < end; p += kThreads)
        out[p] = static_cast<uint8_t>(t.byte_at(p - base));
    }
  }

  // The zero tail, written by the last tile.
  if (tile == gridDim.x - 1 && base + total < cap) {
    const int64_t z0 = base + total;
    const int64_t wa = (z0 + 3) >> 2, wb = cap >> 2;
    if (wa < wb) {
      for (int64_t w = wa + tid; w < wb; w += kThreads) store_word(out, w, 0);
      if (tid < 3 && z0 + tid < 4 * wa) out[z0 + tid] = 0;
      if (tid >= 3 && tid < 6 && 4 * wb + tid - 3 < cap)
        out[4 * wb + tid - 3] = 0;
    } else {
      for (int64_t p = z0 + tid; p < cap; p += kThreads) out[p] = 0;
    }
  }
}

}  // namespace

// status: one 64-bit word a tile of kTileBlocks blocks (scratch; it needs
// no initialising).
JT_API int jt_deposit_rows(const void* rows, const void* blk_bytes, int64_t n,
                           int32_t W, void* out, int64_t cap, void* status,
                           int32_t device, void* stream) {
  cudaSetDevice(device);
  const int64_t tiles = (n + kTileBlocks - 1) / kTileBlocks;
  if (tiles < 1 || tiles > 0x7fffffff || (reinterpret_cast<uintptr_t>(out) & 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto bb = static_cast<const int32_t*>(blk_bytes);
  const auto st = static_cast<uint64_t*>(status);
  tile_totals_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(bb, n,
                                                                       st);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  deposit_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      static_cast<const uint32_t*>(rows), bb, n, W,
      static_cast<uint8_t*>(out), cap, st);
  return static_cast<int>(cudaGetLastError());
}
