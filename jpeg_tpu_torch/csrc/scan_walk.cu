// K6: speculative boundary-scan walkers, stream bytes -> end table; and
// K6', the same walkers capped and resumed (the two-sweep form).
//
// Replaces the Pallas kernels jpeg_tpu/ops/pallas_kernels.py
// `_scan_walk_kernel_single` (the single sweep, CAP = 0) and
// `_scan_walk_kernel` (the capped / resumed walkers; wrapper
// `scan_walk_rows` with `cap`, `c0`, `w0`).
//
// What it computes: for every byte q < P of the stream buffer, E[q] is the
// end byte of "the block that starts at q", walked with the host scanner's
// rules (entropy/native/entropy.cpp `jt_scan_offsets`), or
// ERR = P + 1 wherever the host scanner would reject the block: a header
// that runs past `limit` bits, a (run, 0) code with run not in {0, 15}, a
// code whose magnitude runs past `limit`, a coefficient index widx + run
// >= L, or no EOB within L + L/15 + 2 units.  EOB pads to the next byte; a
// zero-run chain (0xF0) adds 15 to the index unchecked, as the host scanner
// does.  E[P] = E[P + 1] = ERR, so ERR absorbs in the orbit chase (K7, K8).
// `limit` is 8 * n_bytes: in a buffer of several bands a walker may run
// across a band boundary, and the chase's per-band end check rejects that.
// A walk reads no header at or past `limit`, so bytes from n_bytes on never
// change E.
//
// The resume entry walks M walkers from start bytes q[i], each already
// `c0[i]` bits into its block with coefficient index `w0[i]`, for at most
// `cap` units, and returns the block's byte length (EOB padded to a byte of
// the block), -1 for a block the host scanner rejects, or -2 for a walker
// still live at the cap, with the bits consumed and the index reached, so
// that a later launch resumes it.  Walkers at index >= *n_live (a count in
// device memory, read by the kernel so that the host never waits for it)
// exit at once and return (-2, c0, w0).
//
// What bounds it on this card: one serial, data-dependent walk per byte.
// Most walkers settle within a few units, a garbage walker may take the
// whole unit budget, and with one walker per thread the slowest lane sets
// its warp's time.  Each unit reads one header near the walker's position.
//
// What the design does about it (single sweep): a block takes a tile of
// `tile` bytes and stages the tile and a halo of `halo` bytes past it into
// shared memory with 16-byte loads, zero past n_bytes and P.  The halo
// covers the longest span a walk can read (ops/kernels.py
// `walk_span_bytes`, capped by `SCAN_HALO_MAX`); a walk that leaves the
// staged bytes reads on from global memory.  Walkers read each header
// through a two-byte window in shared memory.  Lanes are refilled: a warp
// claims 32 bytes of its tile at a time from a shared counter (one atomic),
// and a lane whose walker settled takes the warp's next claimed byte at the
// top of a round (a ballot and a popcount; no atomic, no shuffle).  A lane
// walks up to kUnitsPerRound units a round, which trades the refill's cost
// against lanes idle until the round ends (4 beat 1, 2 and 8 on an NVIDIA
// H100).  So a warp's time is about its share of the tile's units plus one
// long walk, not the sum of its slowest lanes' walks.  The wrapper sizes
// tiles (ops/kernels.py `scan_walk_plan`) so that one wave of blocks fills
// the card: the loop is latency-bound, and it needs every warp slot of an
// SM.  Ends collect in a shared-memory tile and leave with coalesced
// stores; they do not depend on which lane walked which byte.  The tile's
// walkers count bit positions from the tile's first byte in int32 (fewer
// instructions a unit than int64; the wrapper bounds L, so a walk stays
// far below 2**31 bits).  Both entries run one `walk()`, templated on
// where it reads bytes and on the position type, so the rules are in one
// place and a resumed walker continues exactly where the capped one
// stopped.  The resume entry's positions are int64 stream bits, so
// pos + 8 + size never wraps.
// The TPU forms (the overlap-table rows, the alignment prologue, the
// funnel shifts and the lockstep tile that waits for its slowest column)
// are gone.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;        // ops/kernels.py SCAN_THREADS
constexpr int kUnitsPerRound = 4;    // ops/kernels.py SCAN_UNITS_PER_ROUND

enum : int { kLive = 0, kDone = 1, kErr = 2 };

// Headers straight from global memory (K3's 40-bit window).
struct GlobalBytes {
  const uint8_t* s;
  int64_t n;
  __device__ __forceinline__ uint32_t header(int64_t bit) const {
    return jt::peek32(s, n, bit) >> 24;
  }
};

// Headers from the staged bytes [0, n) in shared memory, at bit positions
// counted from the first staged byte, which is stream bit `first_bit`;
// outside them, from global memory.
struct TileBytes {
  const uint8_t* tile;
  int32_t n;
  int64_t first_bit;
  GlobalBytes rest;
  __device__ __forceinline__ uint32_t header(int32_t bit) const {
    const uint32_t b = static_cast<uint32_t>(bit) >> 3;
    if (b + 1 < static_cast<uint32_t>(n)) {
      const uint32_t w = (uint32_t(tile[b]) << 8) | tile[b + 1];
      return (w >> (8 - (bit & 7))) & 0xFFu;
    }
    return rest.header(first_bit + bit);
  }
};

// Walk one block from bit `pos` with coefficient index `widx` for at most
// `units` units, bits below `limit`.  Returns kDone (pos at the EOB
// header), kErr (pos and widx where the rejected unit starts) or kLive
// (the unit budget ran out).  `Pos` is the integer type of the positions:
// int64 for stream bits, int32 for bits counted from a tile.
template <class Bytes, class Pos>
__device__ __forceinline__ int walk(const Bytes& bytes, Pos limit, int L,
                                    int units, Pos& pos, int& widx) {
  for (int unit = 0; unit < units; ++unit) {
    if (pos + 8 > limit) return kErr;                 // truncated header
    const uint32_t h = bytes.header(pos);
    if (h == 0) return kDone;                         // EOB
    if (h == 0xF0) {                                  // zero-run chain
      widx += jt::kMaxRun;
      pos += 8;
      continue;
    }
    const int run = static_cast<int>(h >> 4);
    const int size = static_cast<int>(h & 0xF);
    if (size == 0) return kErr;                       // (run, 0) code
    if (pos + 8 + size > limit) return kErr;          // truncated code
    if (widx + run >= L) return kErr;                 // index overflow
    widx += run + 1;
    pos += 8 + size;
  }
  return kLive;
}

__device__ __forceinline__ int max_units(int L) {
  return L + L / jt::kMaxRun + 2;
}

// dst[i] = src[first + i] for first + i < valid, else 0, for i < count
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

// One block per tile of E: entries [first, first + tile) of (P + 2,).  A
// lane walks up to kUnitsPerRound units between refills.  Positions are
// bits from the tile's first byte.
__global__ void __launch_bounds__(kThreads)
scan_walk_kernel(const uint8_t* __restrict__ stream, int64_t P, int64_t limit,
                 int L, int tile, int halo, int32_t* __restrict__ E) {
  extern __shared__ int4 smem[];
  int32_t* const ends = reinterpret_cast<int32_t*>(smem);
  uint8_t* const bytes = reinterpret_cast<uint8_t*>(ends + tile);
  __shared__ int cursor;
  const int64_t first = int64_t(blockIdx.x) * tile;
  const int staged = tile + halo;
  const int64_t valid = (limit >> 3) < P ? (limit >> 3) : P;
  stage_bytes(bytes, stream, first, staged, valid);
  if (threadIdx.x == 0) cursor = 0;
  __syncthreads();

  const int32_t err = static_cast<int32_t>(P + 1);
  const int todo = static_cast<int>(
      P - first < 0 ? 0 : (P - first < tile ? P - first : tile));
  const TileBytes rd{bytes, staged, first * 8, GlobalBytes{stream, P}};
  // The limit from the tile's first bit; clamped to int32, it still stops
  // every walk, which ends far below 2**31 bits.
  constexpr int64_t kMax = INT32_MAX;
  const int64_t lim = limit - first * 8;
  const int32_t tile_limit =
      static_cast<int32_t>(lim < -1 ? -1 : (lim > kMax ? kMax : lim));
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  const int budget = max_units(L);
  bool live = false, more = true;
  int q = 0, widx = 0, left = 0;
  int32_t pos = 0;
  // The warp's claimed bytes are [chunk, chunk + 32), `used` of them
  // handed out; both are the same in every lane.
  int chunk = 0, used = 32;
  for (;;) {
    // Idle lanes take the warp's next claimed bytes, in lane order; the
    // warp claims 32 more from the tile when they run out.
    unsigned idle = __ballot_sync(0xFFFFFFFFu, !live && more);
    while (idle) {
      if (used == 32) {
        int c = 0;
        if (lane == 0) c = atomicAdd(&cursor, 32);
        chunk = __shfl_sync(0xFFFFFFFFu, c, 0);
        used = 0;
      }
      const int take = min(__popc(idle), 32 - used);
      const bool served = (idle >> lane & 1u) && __popc(idle & below) < take;
      if (served) {
        q = chunk + used + __popc(idle & below);
        if (q < todo) {
          live = true;
          pos = q * 8;
          widx = 0;
          left = budget;
        } else {
          more = false;
        }
      }
      idle &= ~__ballot_sync(0xFFFFFFFFu, served);
      used += take;
    }
    if (__ballot_sync(0xFFFFFFFFu, live) == 0) break;
    if (live) {
      const int n = left < kUnitsPerRound ? left : kUnitsPerRound;
      const int st = walk(rd, tile_limit, L, n, pos, widx);
      left -= n;
      if (st != kLive || left == 0) {   // EOB pads to a byte
        ends[q] = st == kDone ? static_cast<int32_t>(first + ((pos + 15) >> 3))
                              : err;
        live = false;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    if (first + i < P + 2) E[first + i] = i < todo ? ends[i] : err;
  }
}

__global__ void scan_walk_resume_kernel(
    const uint8_t* __restrict__ stream, int64_t P, int64_t limit, int L,
    const int64_t* __restrict__ q, const int32_t* __restrict__ c0,
    const int32_t* __restrict__ w0, int64_t M,
    const int64_t* __restrict__ n_live, int cap,
    int32_t* __restrict__ len, int32_t* __restrict__ c_out,
    int32_t* __restrict__ w_out) {
  const int64_t live = n_live ? *n_live : M;
  const GlobalBytes rd{stream, P};
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < M;
       i += int64_t(gridDim.x) * blockDim.x) {
    const int c_in = c0 ? c0[i] : 0;
    int widx = w0 ? w0[i] : 0;
    int32_t out = -2;
    int64_t pos = 0;
    if (i < live) {
      const int64_t start = q[i] * 8;
      pos = start + c_in;
      const int st = walk(rd, limit, L, cap, pos, widx);
      pos -= start;
      if (st == kDone) out = static_cast<int32_t>((pos + 15) >> 3);
      else if (st == kErr) out = -1;
    } else {
      pos = c_in;
    }
    len[i] = out;
    c_out[i] = static_cast<int32_t>(pos);
    w_out[i] = widx;
  }
}

}  // namespace

JT_API int jt_scan_walk(const void* stream_bytes, int64_t P, int64_t limit,
                        int32_t L, int32_t tile, int32_t halo,
                        void* end_table, int32_t device, void* stream) {
  cudaSetDevice(device);
  const int64_t blocks = (P + 2 + tile - 1) / tile;
  const size_t smem = size_t(tile) * sizeof(int32_t) + tile + halo;
  scan_walk_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(stream_bytes), P, limit, L, tile, halo,
      static_cast<int32_t*>(end_table));
  return static_cast<int>(cudaGetLastError());
}

JT_API int jt_scan_walk_resume(const void* stream_bytes, int64_t P,
                               int64_t limit, int32_t L, const void* q,
                               const void* c0, const void* w0, int64_t M,
                               const void* n_live, int32_t cap, void* len,
                               void* c_out, void* w_out, int32_t device,
                               void* stream) {
  cudaSetDevice(device);
  const int threads = 256;
  scan_walk_resume_kernel<<<jt::grid_for(M, threads), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(stream_bytes), P, limit, L,
      static_cast<const int64_t*>(q), static_cast<const int32_t*>(c0),
      static_cast<const int32_t*>(w0), M,
      static_cast<const int64_t*>(n_live), cap, static_cast<int32_t*>(len),
      static_cast<int32_t*>(c_out), static_cast<int32_t*>(w_out));
  return static_cast<int>(cudaGetLastError());
}
