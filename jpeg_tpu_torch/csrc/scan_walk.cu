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
// K6' walks the same blocks for at most `cap` units and carries a walker
// still live at the cap, (bits consumed from its block's start, index
// reached), to a later launch that resumes it for the rest of the unit
// budget.  Its two forms:
// * the range form (sweep 1 of the two-sweep end table) walks every byte
//   of [0, P) from its block's start, a tile of bytes a thread block, as K6
//   does.  It writes E straight, with ERR where a walker is still live, and
//   appends each live walker (start byte, bits, index) to a survivor list
//   in device memory; with a cap that covers the budget there is no list
//   and a live walker is ERR.
// * the list form (`scan_walk_resume`) resumes M walkers from start bytes
//   q[i], each `c0[i]` bits into its block with index `w0[i]`.  Only the
//   first *n_live walk (a count in device memory, so that the host never
//   waits for it).  It writes each walker's (length, bits, index): the
//   length is the block's byte length (EOB padded to a byte of the block),
//   -1 for a block the host scanner rejects, -2 for a walker still live at
//   the cap, and (-2, c0, w0) past the count.  For the end table (sweep 2)
//   the list is sweep 1's survivors, and it writes E[q] = q + length or ERR
//   instead.
//
// What bounds it on this card: one serial, data-dependent walk per byte.
// Most walkers settle within a few units, a garbage walker may take the
// whole unit budget, and with one walker per thread the slowest lane sets
// its warp's time.  Each unit reads one header near the walker's position.
// The two-sweep table's bytes are K6's (P in, 4(P + 2) out) plus its
// survivors' 16 bytes each, out and back in.
//
// What the design does about it (the range form and K6): a block takes a
// tile of `tile` bytes and stages the tile and a halo of `halo` bytes past
// it into shared memory with 16-byte loads, zero past n_bytes and P.  The
// halo covers the longest span a walk can read (ops/kernels.py
// `walk_span_bytes`, capped by `SCAN_HALO_MAX`; for a capped walk
// `capped_span_bytes`, 48 bytes at cap 12); a walk that leaves the staged
// bytes reads on from global memory.  Walkers read each header through a
// two-byte window in shared memory.  Lanes are refilled: a warp claims 32
// bytes of its tile at a time from a shared counter (one atomic), and a
// lane whose walker settled takes the warp's next claimed byte at the top
// of a round (a ballot and a popcount; no atomic, no shuffle).  A lane
// walks up to kUnitsPerRound units a round, which trades the refill's cost
// against lanes idle until the round ends (on an NVIDIA H100, 4 beat 1, 2
// and 8 for K6, and for sweep 1 at cap 12 also walking to the cap).  So a warp's time is about its share of
// the tile's units plus one long walk, not the sum of its slowest lanes'
// walks.  The wrapper sizes tiles (ops/kernels.py `scan_walk_plan`) so that
// one wave of blocks fills the card: the loop is latency-bound, and it
// needs every warp slot of an SM.  Ends collect in a shared-memory tile and
// leave with coalesced stores; they do not depend on which lane walked
// which byte.  A survivor leaves its bits and index in the shared tile; at
// the block's end one atomicAdd on the count reserves the tile's slots of
// the list, and each warp copies out the survivors among 32 entries (a
// ballot and a shared atomic): their order is free, since E does not
// depend on it.  The tile's walkers count bit positions from the tile's
// first byte in int32 (fewer instructions a unit than int64; the wrapper
// bounds L, so a walk stays far below 2**31 bits).
//
// The list form: a persistent grid of at most half a wave (ops/kernels.py
// `scan_resume_blocks`; it beat a quarter and a whole wave); each warp
// takes chunks of 32 walkers, striding over the list, and refills idle
// lanes from them as the range form does, so that the long walks of the
// survivors (up to budget - cap units each) do not cost whole warps.  Each walker reads
// its headers through a 64-bit bit buffer refilled with aligned big-endian
// words from global memory (K3's reader; zero outside the stream, so
// garbage starts stay safe), not five byte loads a unit.  Its positions are
// int64 bits from its block's start, so the EOB pad stays block-relative
// and pos + 8 + size never wraps.
//
// Every form runs one `walk()`, templated on where it reads bytes and on
// the position type, so the host scanner's rules are in one place and a
// resumed walker continues exactly where the capped one stopped.  The TPU
// forms (the overlap-table rows, the alignment prologue, the funnel shifts,
// the lockstep tile that waits for its slowest column, and the two-sweep
// table's fixed-shape compaction) are gone.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;        // ops/kernels.py SCAN_THREADS
constexpr int kUnitsPerRound = 4;    // ops/kernels.py SCAN_UNITS_PER_ROUND
constexpr unsigned kAll = 0xFFFFFFFFu;

enum : int { kLive = 0, kDone = 1, kErr = 2 };

// What a range-form launch writes: K6's end table, or sweep 1's end table
// and survivor list.
enum Mode : int { kTable = 0, kCapped = 1 };

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

// One walker's headers from global memory through a 64-bit bit buffer:
// `buf` holds the stream bits from position `base` on (bits from the
// block's first bit), MSB first, and takes the next big-endian word when a
// header starts 32 bits or more into it.  Positions only move forward, at
// most 23 bits a unit, so one word a header at most keeps the header
// inside the buffer.
struct StreamBits {
  const uint8_t* s;
  int64_t n;
  bool aligned;        // s is 4-byte aligned: whole words load at once
  int64_t base;
  int64_t next;        // the stream word after the buffer
  uint64_t buf;

  __device__ __forceinline__ uint32_t word(int64_t w) const {
    const int64_t b = 4 * w;
    if (aligned && b >= 0 && b + 4 <= n)
      return __byte_perm(__ldg(reinterpret_cast<const uint32_t*>(s) + w), 0,
                         0x0123);
    uint32_t v = 0;
    for (int j = 0; j < 4; ++j)
      v = (v << 8) | ((b + j >= 0 && b + j < n) ? s[b + j] : 0u);
    return v;
  }
  // Start at position `pos` of the block whose first bit is `start`.
  __device__ __forceinline__ void seek(int64_t start, int64_t pos) {
    const int64_t w = (start + pos) >> 5;
    base = w * 32 - start;
    buf = (uint64_t(word(w)) << 32) | word(w + 1);
    next = w + 2;
  }
  __device__ __forceinline__ uint32_t header(int64_t bit) {
    int64_t off = bit - base;
    if (off >= 32) {
      buf = (buf << 32) | word(next++);
      base += 32;
      off -= 32;
    }
    return static_cast<uint32_t>(buf >> (56 - off)) & 0xFFu;
  }
};

// Walk one block from bit `pos` with coefficient index `widx` for at most
// `units` units, bits below `limit`.  Returns kDone (pos at the EOB
// header), kErr (pos and widx where the rejected unit starts) or kLive
// (the unit budget ran out).  `Pos` is the integer type of the positions:
// int64 for bits from a block's start, int32 for bits counted from a tile.
template <class Bytes, class Pos>
__device__ __forceinline__ int walk(Bytes& bytes, Pos limit, int L,
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

// Lane refill: the lanes in `idle` (the same mask in every lane) take the
// warp's next work items in lane order.  The warp's claimed items are
// [chunk, chunk + 32), `used` of them handed out (both the same in every
// lane); when they run out, `claim()` (called by the whole warp) gives the
// first of 32 more.  Returns whether this lane was served, and its item.
template <class Item, class Claim>
__device__ __forceinline__ bool refill(unsigned idle, Claim& claim,
                                       Item& chunk, int& used, Item& item) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  bool got = false;
  while (idle) {
    if (used == 32) {
      chunk = claim();
      used = 0;
    }
    const int rank = __popc(idle & below);
    const int take = min(__popc(idle), 32 - used);
    const bool served = (idle >> lane & 1u) && rank < take;
    if (served) {
      item = chunk + used + rank;
      got = true;
    }
    idle &= ~__ballot_sync(kAll, served);
    used += take;
  }
  return got;
}

// The walkers still live at the cap of sweep 1: start byte, bits from it,
// index reached, and their count (zeroed before the launch).
struct Survivors {
  int64_t* q;
  int32_t* c;
  int32_t* w;
  unsigned long long* n;
};

// Every walker's (length, bits, index): the list form's outputs.
struct Walkers {
  int32_t* len;
  int32_t* c;
  int32_t* w;
};

// The range form: one block per tile of walkers [first, first + tile),
// each from bit 0 of its own byte, a lane walking kUnitsPerRound units
// between refills.  kTable is K6 (the whole budget); kCapped walks at most
// `cap` units.  Both write entries [first, first + tile) of the (P + 2,)
// table.  Positions are bits from the tile's first byte.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
scan_walk_kernel(const uint8_t* __restrict__ stream, int64_t P, int64_t limit,
                 int L, int cap, int tile, int halo, int32_t* __restrict__ E,
                 Survivors surv) {
  // Shared: the tile's ends (a survivor's is -1 - its bits), its
  // survivors' indices (kCapped), then the staged bytes.
  extern __shared__ int4 smem[];
  int32_t* const ends = reinterpret_cast<int32_t*>(smem);
  int32_t* const widths = ends + tile;
  uint8_t* const bytes =
      reinterpret_cast<uint8_t*>(widths + (kMode == kCapped ? tile : 0));
  __shared__ int cursor, survivors;
  __shared__ unsigned long long list_at;
  const int64_t first = int64_t(blockIdx.x) * tile;
  const int staged = tile + halo;
  const int64_t valid = (limit >> 3) < P ? (limit >> 3) : P;
  stage_bytes(bytes, stream, first, staged, valid);
  if (threadIdx.x == 0) cursor = survivors = 0;
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
  const int budget = kMode == kTable ? max_units(L) : min(cap, max_units(L));
  auto claim = [&] {
    int c = 0;
    if (lane == 0) c = atomicAdd(&cursor, 32);
    return __shfl_sync(kAll, c, 0);
  };
  bool live = false, more = true;
  int q = 0, widx = 0, left = 0;
  int32_t pos = 0;
  int chunk = 0, used = 32;
  for (;;) {
    // Idle lanes take the warp's next claimed bytes; the warp claims 32
    // more from the tile when they run out.
    int got = 0;
    if (refill(__ballot_sync(kAll, !live && more), claim, chunk, used, got)) {
      q = got;
      if (q < todo) {
        live = true;
        pos = q * 8;
        widx = 0;
        left = budget;
      } else {
        more = false;
      }
    }
    if (__ballot_sync(kAll, live) == 0) break;
    if (live) {
      const int n = left < kUnitsPerRound ? left : kUnitsPerRound;
      const int st = walk(rd, tile_limit, L, n, pos, widx);
      left -= n;
      if (st != kLive || left == 0) {
        live = false;
        if (kMode == kCapped && st == kLive && surv.n != nullptr) {
          ends[q] = -1 - (pos - q * 8);       // a survivor: its bits
          widths[q] = widx;
        } else {
          ends[q] = st == kDone
                        ? static_cast<int32_t>(first + ((pos + 15) >> 3))
                        : err;
        }
      }
    }
  }
  __syncthreads();
  if (kMode == kCapped && surv.n != nullptr) {
    // The tile's survivors: counted, one atomicAdd reserves their slots of
    // the list, and each warp copies out the survivors of its 32 entries.
    const int warp0 = threadIdx.x & ~31;
    const unsigned below = (1u << lane) - 1;
    for (int i0 = warp0; i0 < todo; i0 += blockDim.x) {
      const unsigned b = __ballot_sync(kAll, i0 + lane < todo &&
                                                 ends[i0 + lane] < 0);
      if (lane == 0 && b) atomicAdd(&survivors, __popc(b));
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      list_at = atomicAdd(surv.n, 0ull + survivors);
      cursor = 0;
    }
    __syncthreads();
    for (int i0 = warp0; i0 < todo; i0 += blockDim.x) {
      const int i = i0 + lane;
      const bool mine = i < todo && ends[i] < 0;
      const unsigned b = __ballot_sync(kAll, mine);
      int at = 0;
      if (lane == 0 && b) at = atomicAdd(&cursor, __popc(b));
      at = __shfl_sync(kAll, at, 0) + __popc(b & below);
      if (mine) {
        surv.q[list_at + at] = first + i;
        surv.c[list_at + at] = -1 - ends[i];
        surv.w[list_at + at] = widths[i];
      }
    }
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    if (first + i < P + 2)
      E[first + i] = i < todo && ends[i] >= 0 ? ends[i] : err;
  }
}

// The list form: walkers [0, *n_live) of q / c0 / w0 resumed for at most
// `steps` units.  Table: E[q[i]] = q[i] + length or ERR (a walker still
// live after `steps` has used the whole budget); otherwise every walker's
// (length, bits, index), (-2, c0, w0) past the count.  Warp k of the grid
// takes chunks k, k + warps, k + 2 warps, ... of 32 walkers.
template <bool kTableOut>
__global__ void __launch_bounds__(kThreads)
scan_resume_kernel(const uint8_t* __restrict__ stream, int64_t P,
                   int64_t limit, int L, int steps,
                   const int64_t* __restrict__ q,
                   const int32_t* __restrict__ c0,
                   const int32_t* __restrict__ w0, int64_t M,
                   const int64_t* __restrict__ n_live,
                   int32_t* __restrict__ E, Walkers out) {
  const int64_t given = n_live ? *n_live : M;
  const int64_t count = given < 0 ? 0 : (given < M ? given : M);
  const int64_t thread = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t threads = int64_t(gridDim.x) * blockDim.x;
  if (!kTableOut) {
    for (int64_t i = count + thread; i < M; i += threads) {
      out.len[i] = -2;
      out.c[i] = c0 ? c0[i] : 0;
      out.w[i] = w0 ? w0[i] : 0;
    }
  }
  const int32_t err = static_cast<int32_t>(P + 1);
  int64_t next = (thread >> 5) * 32;
  auto claim = [&] {
    const int64_t c = next;
    next += threads;
    return c;
  };
  StreamBits rd{stream, P, (reinterpret_cast<uintptr_t>(stream) & 3) == 0};
  bool live = false, more = true;
  int64_t i = 0, qi = 0, pos = 0, lim = 0, chunk = 0;
  int widx = 0, left = 0, used = 32;
  for (;;) {
    int64_t got = 0;
    if (refill(__ballot_sync(kAll, !live && more), claim, chunk, used, got)) {
      if (got < count) {
        i = got;
        qi = q[i];
        pos = c0 ? c0[i] : 0;
        widx = w0 ? w0[i] : 0;
        lim = limit - qi * 8;
        rd.seek(qi * 8, pos);
        left = steps;
        live = true;
      } else {
        more = false;
      }
    }
    if (__ballot_sync(kAll, live) == 0) break;
    if (live) {
      const int n = left < kUnitsPerRound ? left : kUnitsPerRound;
      const int st = walk(rd, lim, L, n, pos, widx);
      left -= n;
      if (st != kLive || left == 0) {
        live = false;
        const int32_t len = st == kDone ? static_cast<int32_t>((pos + 15) >> 3)
                                        : (st == kErr ? -1 : -2);
        if (kTableOut) {
          E[qi] = len >= 0 ? static_cast<int32_t>(qi + len) : err;
        } else {
          out.len[i] = len;
          out.c[i] = static_cast<int32_t>(pos);
          out.w[i] = widx;
        }
      }
    }
  }
}

template <int kMode>
cudaError_t launch_range(const uint8_t* s, int64_t P, int64_t limit, int L,
                         int cap, int tile, int halo, int32_t* E,
                         Survivors surv, cudaStream_t stream) {
  const int64_t blocks = (P + 2 + tile - 1) / tile;
  const int words = kMode == kCapped ? 2 : 1;
  const size_t smem = size_t(words) * tile * sizeof(int32_t) + tile + halo;
  scan_walk_kernel<kMode><<<static_cast<unsigned>(blocks), kThreads, smem,
                            stream>>>(s, P, limit, L, cap, tile, halo, E,
                                      surv);
  return cudaGetLastError();
}

}  // namespace

JT_API int jt_scan_walk(const void* stream_bytes, int64_t P, int64_t limit,
                        int32_t L, int32_t tile, int32_t halo,
                        void* end_table, int32_t device, void* stream) {
  cudaSetDevice(device);
  return static_cast<int>(launch_range<kTable>(
      static_cast<const uint8_t*>(stream_bytes), P, limit, L, 0, tile, halo,
      static_cast<int32_t*>(end_table), Survivors{},
      static_cast<cudaStream_t>(stream)));
}

// The range form: sweep 1, writing the table and, when `surv_n` is given,
// zeroing it and appending the live walkers to the survivor list.
JT_API int jt_scan_walk_capped(const void* stream_bytes, int64_t P,
                               int64_t limit, int32_t L, int32_t cap,
                               int32_t tile, int32_t halo, void* end_table,
                               void* surv_q, void* surv_c, void* surv_w,
                               void* surv_n, int32_t device, void* stream) {
  cudaSetDevice(device);
  const auto st = static_cast<cudaStream_t>(stream);
  if (cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Survivors surv{static_cast<int64_t*>(surv_q),
                       static_cast<int32_t*>(surv_c),
                       static_cast<int32_t*>(surv_w),
                       static_cast<unsigned long long*>(surv_n)};
  if (surv.n != nullptr) {
    const cudaError_t e = cudaMemsetAsync(surv.n, 0, sizeof(*surv.n), st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(launch_range<kCapped>(
      static_cast<const uint8_t*>(stream_bytes), P, limit, L, cap, tile,
      halo, static_cast<int32_t*>(end_table), surv, st));
}

// The list form on `blocks` thread blocks.  With `end_table`: sweep 2,
// writing the table entries of the walkers.  Without: every walker's
// (length, bits, index).
JT_API int jt_scan_walk_resume(const void* stream_bytes, int64_t P,
                               int64_t limit, int32_t L, const void* q,
                               const void* c0, const void* w0, int64_t M,
                               const void* n_live, int32_t steps,
                               int32_t blocks, void* end_table, void* len,
                               void* c_out, void* w_out, int32_t device,
                               void* stream) {
  cudaSetDevice(device);
  if (blocks < 1 || steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<const uint8_t*>(stream_bytes);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto qs = static_cast<const int64_t*>(q);
  const auto cs = static_cast<const int32_t*>(c0);
  const auto ws = static_cast<const int32_t*>(w0);
  const auto n = static_cast<const int64_t*>(n_live);
  const auto E = static_cast<int32_t*>(end_table);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (E != nullptr) {
    scan_resume_kernel<true><<<grid, kThreads, 0, st>>>(
        s, P, limit, L, steps, qs, cs, ws, M, n, E, Walkers{});
  } else {
    scan_resume_kernel<false><<<grid, kThreads, 0, st>>>(
        s, P, limit, L, steps, qs, cs, ws, M, n, nullptr,
        Walkers{static_cast<int32_t*>(len), static_cast<int32_t*>(c_out),
                static_cast<int32_t*>(w_out)});
  }
  return static_cast<int>(cudaGetLastError());
}
