// K3: block-parallel bitstream decode, stream bytes -> (N, L) levels.
//
// Replaces the Pallas kernel jpeg_tpu/ops/pallas_kernels.py
// `_decode_stream_kernel` (wrapper `decode_stream_rows`).
//
// What it computes: block i starts at byte starts[i] (from a boundary
// scan).  One code per step, at most L + L//15 + 2 steps: the top byte of
// the next 32 bits is run:4 | size:4.  (0, 0) is EOB and ends the block;
// (15, 0) is a zero-run chain and adds 15 to the coefficient index;
// anything else is a code whose amplitude (sign bit 1 = positive, then
// size-1 magnitude bits) goes to index widx + run, which then advances past
// it.  A code whose index would reach L stores nothing and leaves the index
// where it was, as the TPU kernel's `wt < L` gate does.  Every other
// element of the (N, L) output is zero; the kernel writes all of them.
// Bytes outside [0, nbytes) read as zero, which decodes as EOB, so the
// starts of a device scan whose check failed (garbage, out of order, up to
// one past the end or beyond) decode safely before the check is read.
//
// What bounds it on this card: its bytes, 4*N*L of levels out (12.6 MB at
// the 2048x2048 main path, N = 49,152, L = 64) against 1.4 MB of stream and
// 0.4 MB of starts in: 0.0043 ms at 3.35 TB/s.  The walks themselves are
// serial and data-dependent, a few codes a block, and the stream sits in
// L2, so what costs is around them: a thread per block storing its codes
// straight into its row needs a separate zero-fill launch, and a warp's
// stores then touch 32 rows 256 B apart (a sector a lane); reading each
// code's window byte by byte from global memory costs five bounds-checked
// loads a code.
//
// What the design does about it: a thread block takes a tile of `tile`
// consecutive blocks (ops/kernels.py `decode_stream_plan`: at most kThreads,
// and no more than DECODE_LEVEL_BYTES of levels: 32 at L = 64, 4 at L = 576,
// 128 at L = 9).  The walks are one thread a block whatever the tile, while
// the staging, the zeroing and the stores spread over all kThreads: on an
// H100 tiles of 8-12 KB of levels were the fastest at the 2048x2048 and
// d = 24 streams (larger ones leave more of that work to each thread,
// smaller ones too few walkers resident).  It stages the tile's stream span,
// from its first start (rounded down to 16 bytes) to its last start plus
// `halo` bytes (the longest block the encoder writes at L, plus the words a
// walk reads past its EOB), at most kSpanBytes, into shared memory with
// 16-byte loads, and zeroes a tile x L level tile in shared memory.  Thread
// j walks block i0 + j through a 64-bit bit buffer refilled a big-endian
// word at a time, from the staged bytes where a word lies inside them and
// from global memory (bounds-checked, zero outside the stream) where it does
// not: a span over the budget, starts out of order, garbage starts.  Codes
// store into the level tile; the tile's rows are contiguous in the output,
// so it leaves with coalesced 16-byte stores (element stores when L is not a
// multiple of 4 or the output is not 16-byte aligned), zeros included: one
// launch a call, no memset.  The TPU forms (the overlap table and its row
// gather, the alignment prologue, little-endian word upload, the length sort
// that evened out lockstep tiles) are gone.
#include "common.cuh"

namespace {

// Threads a thread block, and so the largest tile (one walker a thread).
constexpr int kThreads = 128;          // ops/kernels.py DECODE_TILE_MAX
// The most stream bytes a tile stages.
constexpr int kSpanBytes = 4 << 10;    // ops/kernels.py DECODE_SPAN_BYTES
constexpr int kDefaultSmem = 48 << 10; // dynamic shared memory without opt-in
constexpr int kMaxSmem = 227 << 10;    // an H100's most a block may opt in to

// Big-endian stream word w (bytes [4w, 4w + 4), zero outside [0, nbytes)):
// from the staged window [lo, lo + count) where the word lies inside it,
// else from global memory.
struct Words {
  const uint8_t* __restrict__ s;
  int64_t nbytes;
  const uint32_t* win;   // the window's native (little-endian) words
  int64_t lo;            // its first byte, a multiple of 16
  int count;             // its bytes, a multiple of 16
  __device__ __forceinline__ uint32_t operator()(int64_t w) const {
    const int64_t off = 4 * w - lo;
    if (off >= 0 && off < count)
      return __byte_perm(win[off >> 2], 0, 0x0123);
    uint32_t v = 0;
    for (int j = 0; j < 4; ++j) {
      const int64_t b = 4 * w + j;
      v = (v << 8) | ((b >= 0 && b < nbytes) ? s[b] : 0u);
    }
    return v;
  }
};

// Decode one block from byte `start` into the zeroed row o[0, L).
__device__ __forceinline__ void walk(const Words& words, int64_t start, int L,
                                     int32_t* o) {
  const int max_steps = L + L / jt::kMaxRun + 2;
  int64_t w = start >> 2;
  const int skip = 8 * static_cast<int>(start & 3);
  uint64_t buf = uint64_t(words(w++)) << (32 + skip);   // MSB-aligned bits
  int nbits = 32 - skip;
  int widx = 0;
  for (int step = 0; step < max_steps; ++step) {
    if (nbits < 32) {
      buf |= uint64_t(words(w++)) << (32 - nbits);
      nbits += 32;
    }
    const uint32_t win = static_cast<uint32_t>(buf >> 32);
    const int run = static_cast<int>(win >> 28);
    const int size = static_cast<int>((win >> 24) & 0xF);
    if (size == 0 && run == 0) break;                   // EOB
    int used = 8;
    if (size == 0 && run == jt::kMaxRun) {              // zero-run chain
      widx += jt::kMaxRun;
    } else {
      const int nmag = size > 0 ? size - 1 : 0;
      const int32_t mag = static_cast<int32_t>(
          (win >> (23 - nmag)) & ((1u << nmag) - 1u));
      const int wt = widx + run;
      if (wt < L) {
        o[wt] = ((win >> 23) & 1u) ? mag : -mag;
        widx = wt + 1;
      }
      used += size;
    }
    buf <<= used;
    nbits -= used;
  }
}

// dst[i] = src[first + i] for 0 <= first + i < valid, else 0, for i < count
// (a multiple of 16; first too).
__device__ __forceinline__ void stage_bytes(uint8_t* __restrict__ dst,
                                            const uint8_t* __restrict__ src,
                                            int64_t first, int count,
                                            int64_t valid) {
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (int i = threadIdx.x * 16; i < count; i += blockDim.x * 16) {
    const int64_t g = first + i;
    if (aligned && g + 16 <= valid) {
      *reinterpret_cast<uint4*>(dst + i) =
          __ldg(reinterpret_cast<const uint4*>(src + g));
    } else {
      for (int j = 0; j < 16; ++j) dst[i + j] = g + j < valid ? src[g + j] : 0;
    }
  }
}

__host__ __device__ constexpr int round16(int64_t b) {
  return static_cast<int>((b + 15) & ~int64_t(15));
}

// One thread block per tile of blocks [i0, i0 + tile), tile <= kThreads.
__global__ void __launch_bounds__(kThreads)
decode_stream_kernel(const uint8_t* __restrict__ stream, int64_t nbytes,
                     const int64_t* __restrict__ starts, int64_t n, int L,
                     int tile, int halo, int32_t* __restrict__ out,
                     bool vec_out) {
  extern __shared__ int4 smem[];
  int32_t* const lv = reinterpret_cast<int32_t*>(smem);
  const int lv_words = tile * L;
  uint8_t* const win =
      reinterpret_cast<uint8_t*>(smem) + round16(int64_t(4) * lv_words);
  const int64_t i0 = int64_t(blockIdx.x) * tile;
  const int rows = n - i0 < tile ? static_cast<int>(n - i0) : tile;

  // The window: the tile's first start (in the stream, down to 16 bytes)
  // to its last start plus the halo, at most kSpanBytes.
  const int64_t first = starts[i0], last = starts[i0 + rows - 1];
  const int64_t lo =
      (first < 0 ? 0 : (first > nbytes ? nbytes : first)) & ~int64_t(15);
  const int64_t want = (last > lo ? last - lo : 0) + halo;
  const int count = want < kSpanBytes ? round16(want) : kSpanBytes;
  stage_bytes(win, stream, lo, count, nbytes);
  for (int i = threadIdx.x; i < lv_words / 4; i += blockDim.x)
    smem[i] = make_int4(0, 0, 0, 0);
  for (int i = (lv_words / 4) * 4 + threadIdx.x; i < lv_words; i += blockDim.x)
    lv[i] = 0;
  __syncthreads();

  const int j = threadIdx.x;
  if (j < rows) {
    const Words words{stream, nbytes, reinterpret_cast<const uint32_t*>(win),
                      lo, count};
    walk(words, starts[i0 + j], L, lv + j * L);
  }
  __syncthreads();

  const int total = rows * L;
  if (vec_out) {
    int4* dst = reinterpret_cast<int4*>(out + i0 * L);
    for (int i = threadIdx.x; i < total / 4; i += blockDim.x) dst[i] = smem[i];
  } else {
    for (int i = threadIdx.x; i < total; i += blockDim.x)
      out[i0 * L + i] = lv[i];
  }
}

}  // namespace

JT_API int jt_decode_stream(const void* stream_bytes, int64_t nbytes,
                            const void* starts, int64_t n, int32_t L,
                            int32_t tile, int32_t halo, void* out,
                            int32_t device, void* stream) {
  cudaSetDevice(device);
  const int64_t level_bytes = int64_t(4) * tile * L;
  if (tile < 1 || tile > kThreads || halo < 0 || L < 1 ||
      level_bytes + kSpanBytes > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = (n + tile - 1) / tile;
  if (tiles < 1 || tiles > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = size_t(round16(level_bytes)) + kSpanBytes;
  if (smem > size_t(kDefaultSmem)) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool vec_out =
      L % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  decode_stream_kernel<<<static_cast<unsigned>(tiles), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(stream_bytes), nbytes,
      static_cast<const int64_t*>(starts), n, L, tile, halo,
      static_cast<int32_t*>(out), vec_out);
  return static_cast<int>(cudaGetLastError());
}
