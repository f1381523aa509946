// K10: the segmented boundary scan, stream bytes -> every band's block
// starts and one check, with no end table.
//
// It has no Pallas counterpart.  A device decode whose bands hold at least
// entropy/device_scan.py `SEGMENTED_MIN_BLOCKS` blocks takes it in place of
// K6's end table (scan_walk.cu) and K8's long form (chase.cu).
//
// What it computes: band b holds bytes [first_b, end_b) of the stream
// buffer and nb blocks.  From a byte p < end_b the band's walk steps to the
// end of the block that starts at p where the host scanner's rules
// (`walk()`, scan_walk.cuh, reading no bit at or past end_b) accept it,
// and to p + 1 where they reject it.  A step depends only on p and the
// bytes, and p < step(p) <= end_b, so every walk ends at end_b.  The exact
// walk starts at first_b; starts[b * nb + i] is its i-th accepted
// position, for i < nb.  status[0] is zero exactly when every band's exact
// walk rejects nothing and accepts nb blocks (it counts the faults found:
// a band's count other than nb, a rejection in segment 0, a walker on the
// exact walk that met one), and a band passes exactly when K6 + K8 accept
// it.  K8 follows the end table, whose walks read up to the last band's
// end, from first_b for nb blocks and checks that the chain ends at end_b.
// A chain that stays inside band b reads no bit past end_b, so its blocks
// are the band walk's; a block whose walk reads past end_b ends past it,
// and the chain (E[q] > q) never comes back to end_b.  So K8's check holds
// exactly when the band walk's first nb positions are accepted and the
// last of them ends at end_b, which is when the exact walk rejects nothing
// and accepts nb blocks; then the starts are K8's, bit for bit.  Where a
// band fails, its starts are the exact walk's first accepted positions,
// then end_b: any of them is safe for K3.  status[1] counts the unsynced
// walkers (below).
//
// What bounds it on this card: each walk is serial, a data-dependent unit
// after another, so the walk is bound by latency: the card needs many
// walkers, each reading its headers from shared memory.  The bytes are
// few: the stream once, a bit a byte of bitmap out and back, 8 bytes a
// start out (about 20 us for a 47 MB container at 3.35 TB/s).  K6 walked
// a block from every byte (about 16 M block walks there to find 1.1 M
// blocks) into a 4-bytes-a-byte table, and K8's long form built a second
// such table and chased each band through one SM.
//
// The design: four launches on the caller's stream, the bands' offsets as
// launch arguments (no copy, no host wait).  Each band is cut into
// segments of S bytes (S a multiple of 32; ops/kernels.py
// `SEGMENT_BYTES`), a walker each; a band's walkers take a multiple of
// kThreads slots, so no thread block or warp holds two bands.
//  1. Walk: a thread block stages its kThreads segments and a halo of the
//     longest walk (ops/kernels.py `walk_span_bytes`) into shared memory
//     with 16-byte loads (none where that would not fit: then every read
//     goes to global memory).  Segment k's walker steps from the segment's
//     first byte until it leaves the segment, kUnitsPerRound units a round
//     as K6's lanes walk, so that a warp's lanes stay within a round of
//     each other whatever their blocks' lengths, and marks each position it
//     accepted in the segment's bitmap (a bit a byte, S / 32 words, written
//     whole by their owner).  It keeps where it stopped, how many it
//     accepted and its last rejected position.  Segment 0's walker is the
//     exact walk.
//  2. Stitch (a launch of its own, so every bitmap is whole): each walker
//     steps on from its stop, reading through K6's bit buffer
//     (`StreamBits`), until it reaches a position that the walker of the
//     segment it is in accepted, or end_b.  From that entry on the two
//     walks are one, since a step depends only on the position.  It keeps
//     the segment it met (its link), the entry, the positions it accepted
//     on the way (the first kCont of them), their count plus the met
//     walker's accepted positions from the entry on (its gain), and
//     whether it rejected a position on the way or the met walker rejected
//     one past the entry.  A walker that meets nothing in the next segment
//     walks on through it by itself and links past it (a skipper): that
//     costs time, never correctness.  status[1] counts the skippers.  Each
//     warp leaves the exclusive sums of its walkers' gains, its total and
//     a bit a skipper.
//  3. Resolve, a thread block a band: a block scan of the warps' totals;
//     the skippers in order (a block-wide compaction of the bits), and one
//     thread follows them: the exact walk is segment 0's walker, then its
//     link's walker from the entry, and so on, so a skipper is on the exact
//     walk when no earlier jump of it passed over it, and then the walkers
//     it passes over are not.  The jumps, with the gains they pass over,
//     go to a list; a band that counts other than nb or rejects in segment
//     0 adds to status[0], and its starts past its count get end_b.
//  4. Write, a thread a walker: a walker that no jump passes over is on the
//     exact walk, entered at the previous walker's entry or the jump's.  It
//     adds 1 to status[0] where it met a rejection, and writes its
//     bitmap's positions from the entry on, then its stitch's starts (kept,
//     or walked again where there were more than kCont), at the index its
//     warp's and its own sums give, less the gains jumped over.
//
// Why a stitch never gives a start the exact walk would not: a walker's
// positions from its entry on are the exact walk's, because the exact walk
// reached the entry and a step depends only on the position.  The starts
// of a walker on the exact walk are its bitmap's positions from the entry
// to its stop and its stitch's accepted positions from its stop to its
// link's entry, in order, and every accepted position of the exact walk
// lies in exactly one such stretch.  A rejected position of the exact walk
// lies in one too: it is either the walker's last rejected position or
// before it, at or past the entry, or a rejection on its stitch, and the
// band fails.  A start that a walker recorded just before it restarted
// (an accepted block followed by a rejected position) is safe for that
// reason: the exact walk is rejected there too.
#include <initializer_list>
#include <mutex>

#include "common.cuh"
#include "scan_walk.cuh"

namespace {

using namespace jt;

constexpr int kMaxBands = 16;        // ops/kernels.py SEGMENT_MAX_BANDS
constexpr int kThreads = 128;        // ops/kernels.py SEGMENT_THREADS
constexpr int kCont = 4;             // ops/kernels.py SEGMENT_KEPT
constexpr int kUnitsPerRound = 4;    // as K6's (scan_walk.cu)
constexpr int kResolveThreads = 1024;
constexpr int kMaxSmem = 227 << 10;
constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr int64_t kMaxPos = INT32_MAX;

// One launch's bands: band b holds stream bytes [first[b], end[b]) and its
// K[b] walkers take slots seg0[b] .. seg0[b + 1] - 1 (a multiple of
// kThreads) of the scratch arrays; b0 is the first band's index among all.
struct Bands {
  int64_t first[kMaxBands];
  int64_t end[kMaxBands];
  int32_t seg0[kMaxBands + 1];
  int32_t K[kMaxBands];
  int32_t n;
  int32_t b0;

  __device__ __forceinline__ int band_of(int64_t g) const {
    int b = 0;
    while (b + 1 < n && g >= seg0[b + 1]) ++b;
    return b;
  }
};

// The scratch: an entry a walker slot in each of the first arrays (kCont
// in `cont`, S / 32 words in `bits`), one a warp in `wsum` and `skip`, one
// a band in `nint`.  Positions are stream bytes (P < 2**31).
struct Segs {
  int32_t* stop;      // where the walker left its segment (walk)
  int32_t* count;     // positions it accepted in the segment (walk)
  int32_t* last_rej;  // its last rejected position there, -1: none (walk)
  int32_t* link;      // the segment it met; the band's K: none (stitch)
  int32_t* entry;     // the position where it met it, or end_b (stitch)
  int32_t* bad;       // a rejection on the way or past the entry (stitch)
  int32_t* pre;       // exclusive sum of its warp's gains before it (stitch)
  int32_t* ncont;     // positions it accepted on the way (stitch)
  int32_t* cont;      // the first kCont of them (stitch)
  int32_t* list;      // a band's skippers, in order (resolve)
  int32_t* jump_from; // the jumps of the exact walk over walkers: from,
  int32_t* jump_to;   //   to, the entry, and the gains passed over by it
  int32_t* jump_entry;//   and the jumps before it (resolve)
  int32_t* jump_gain;
  uint32_t* bits;     // a bit a byte of the segment: accepted there (walk)
  int32_t* wsum;      // a warp's gains (stitch), then the sum of the
                      // band's warps before it (resolve)
  uint32_t* skip;     // a bit a skipper of the warp (stitch)
  int32_t* nint;      // jumps of a band (resolve)
  int32_t words;      // S / 32
  int32_t S;
};

// Headers from a tile of stream bytes staged in shared memory, the stream
// bytes [first, first + n), at positions from a block's first bit, which
// is `origin` bits into the tile; outside the tile, from global memory.
struct TileBits {
  const uint8_t* tile;
  int32_t n;
  int64_t first;
  const uint8_t* s;
  int64_t P;
  int32_t origin;

  __device__ __forceinline__ uint32_t header(int32_t pos) const {
    const int32_t bit = origin + pos;
    const uint32_t b = static_cast<uint32_t>(bit) >> 3;
    if (b + 1 < static_cast<uint32_t>(n)) {
      const uint32_t w = (uint32_t(tile[b]) << 8) | tile[b + 1];
      return (w >> (8 - (bit & 7))) & 0xFFu;
    }
    return peek32(s, P, 8 * first + bit) >> 24;
  }
  __device__ __forceinline__ void seek(int64_t start, int64_t pos) {
    origin = static_cast<int32_t>(start - 8 * first + pos);
  }
  __device__ __forceinline__ void next_block(int64_t bytes) {
    origin += static_cast<int32_t>(8 * bytes);
  }
};

// The bits a block at byte p may read: to the band's end, in int32.
__device__ __forceinline__ int32_t block_limit(int64_t p, int64_t end) {
  const int64_t lim = 8 * (end - p);
  return static_cast<int32_t>(lim < kMaxPos ? lim : kMaxPos);
}

// One step of the band's walk from byte p < end, the reader at p's first
// bit: the end of the block at p where it is accepted (the reader then at
// that block), else p + 1 (the reader moved there).
template <class Pos, class Reader>
__device__ __forceinline__ int64_t step(Reader& rd, int64_t p, int64_t end,
                                        int L, bool& ok) {
  const int64_t lim = 8 * (end - p);
  Pos pos = 0;
  int widx = 0;
  ok = walk(rd, static_cast<Pos>(lim < kMaxPos ? lim : kMaxPos), L,
            max_units(L), pos, widx) == kDone;
  if (ok) {
    const int64_t len = (int64_t(pos) + 15) >> 3;
    rd.next_block(len);
    return p + len;
  }
  rd.seek(8 * (p + 1), 0);
  return p + 1;
}

__device__ __forceinline__ StreamBits stream_bits(const uint8_t* s,
                                                  int64_t P, int64_t p) {
  StreamBits rd{s, P, (reinterpret_cast<uintptr_t>(s) & 3) == 0};
  rd.seek(8 * p, 0);
  return rd;
}

// The bits of bitmap word w at segment offsets `from` and past.
__device__ __forceinline__ uint32_t from_mask(int w, int32_t from) {
  const int32_t lo = 32 * w;
  if (lo >= from) return kAll;
  if (lo + 32 <= from) return 0u;
  return kAll << (from - lo);
}

// Phase 1: a thread block stages its segments (`staged` bytes from the
// first one's first byte, rounded down to 16; 0: none), then each walker
// walks its segment.  The first launch's first thread zeroes the status.
__global__ void __launch_bounds__(kThreads)
segment_walk_kernel(const uint8_t* __restrict__ stream, int64_t P,
                    Bands bands, int L, int staged, Segs s,
                    int32_t* __restrict__ status, bool init) {
  extern __shared__ int4 smem[];
  uint8_t* const tile = reinterpret_cast<uint8_t*>(smem);
  const int64_t g = bands.seg0[0] + int64_t(blockIdx.x) * kThreads +
                    threadIdx.x;
  if (init && g == bands.seg0[0]) status[0] = status[1] = 0;
  const int b = bands.band_of(g);
  const int64_t k = g - bands.seg0[b];
  const int64_t first = bands.first[b], end = bands.end[b];
  const int64_t tile_first = (first + (k - threadIdx.x) * s.S) & ~int64_t(15);
  if (staged) stage_bytes(tile, stream, tile_first, staged, end);
  __syncthreads();
  const bool real = k < bands.K[b];        // else a slot past the band's
  const int64_t seg_first = first + k * s.S;
  const int64_t seg_end = seg_first + s.S < end ? seg_first + s.S : end;
  uint32_t* __restrict__ bits = s.bits + g * s.words;
  TileBits rd{tile, staged, tile_first, stream, P, 0};
  rd.seek(8 * seg_first, 0);
  int64_t p = seg_first;
  int32_t count = 0, last_rej = -1;
  int w = 0;
  uint32_t word = 0;
  // The block at p, kUnitsPerRound units a round, so that the warp's lanes
  // stay within a round of each other whatever their blocks' lengths.
  int32_t pos = 0, lim = block_limit(p, end);
  int widx = 0, left = max_units(L);
  bool live = real && p < seg_end;
  while (__any_sync(kAll, live)) {
    if (!live) continue;
    const int n = left < kUnitsPerRound ? left : kUnitsPerRound;
    const int st = walk(rd, lim, L, n, pos, widx);
    left -= n;
    if (st == kLive && left > 0) continue;
    if (st == kDone) {
      const int32_t o = static_cast<int32_t>(p - seg_first);
      for (; w < (o >> 5); ++w) {
        bits[w] = word;
        word = 0;
      }
      word |= 1u << (o & 31);
      ++count;
      const int32_t len = (pos + 15) >> 3;
      rd.next_block(len);
      p += len;
    } else {                 // rejected, or no EOB within the budget
      last_rej = static_cast<int32_t>(p);
      ++p;
      rd.seek(8 * p, 0);
    }
    pos = 0;
    widx = 0;
    left = max_units(L);
    lim = block_limit(p, end);
    live = p < seg_end;
  }
  if (!real) return;
  for (; w < s.words; ++w) {
    bits[w] = word;
    word = 0;
  }
  s.stop[g] = static_cast<int32_t>(p);
  s.count[g] = count;
  s.last_rej[g] = last_rej;
}

// Phase 2: each walker on from its stop to the first position that the
// walker of the segment it is in accepted, or the band's end; then its
// warp's sums of gains and its skippers.
__global__ void __launch_bounds__(kThreads)
segment_stitch_kernel(const uint8_t* __restrict__ stream, int64_t P,
                      Bands bands, int L, Segs s) {
  const int lane = threadIdx.x & 31;
  const int64_t g = bands.seg0[0] + int64_t(blockIdx.x) * kThreads +
                    threadIdx.x;
  const int b = bands.band_of(g);
  const int64_t g0 = bands.seg0[b];
  const int32_t K = bands.K[b];
  const int32_t k = static_cast<int32_t>(g - g0);
  int32_t gain = 0;
  bool skipper = false;
  if (k < K) {
    const int64_t first = bands.first[b], end = bands.end[b];
    int64_t p = s.stop[g];
    int32_t m = K, off = 0, ncont = 0;
    bool bad = false;
    if (k + 1 < K) {         // the last walker stopped at the band's end
      StreamBits rd = stream_bits(stream, P, p);
      while (p < end) {
        const int64_t o = p - first;
        const int32_t mm = static_cast<int32_t>(o / s.S);
        off = static_cast<int32_t>(o - int64_t(mm) * s.S);
        if ((s.bits[(g0 + mm) * s.words + (off >> 5)] >> (off & 31)) & 1u) {
          m = mm;
          break;
        }
        bool ok;
        const int64_t q = step<int64_t>(rd, p, end, L, ok);
        if (ok) {
          if (ncont < kCont)
            s.cont[g * kCont + ncont] = static_cast<int32_t>(p);
          ++ncont;
        } else {
          bad = true;
        }
        p = q;
      }
    }
    gain = ncont;
    if (m < K) {
      // The met walker's accepted positions from the entry on: its count
      // less those below the entry.
      const int64_t gm = g0 + m;
      const uint32_t* __restrict__ bits = s.bits + gm * s.words;
      int32_t below = 0;
      for (int w = 0; w < (off >> 5); ++w) below += __popc(bits[w]);
      below += __popc(bits[off >> 5] & ~from_mask(off >> 5, off));
      gain += s.count[gm] - below;
      bad |= s.last_rej[gm] >= p;
    }
    s.link[g] = m;
    s.entry[g] = static_cast<int32_t>(p);
    s.bad[g] = bad;
    s.ncont[g] = ncont;
    skipper = m != k + 1;
  }
  int32_t x = gain;
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(kAll, x, d);
    if (lane >= d) x += y;
  }
  s.pre[g] = x - gain;
  const unsigned skips = __ballot_sync(kAll, skipper);
  if (lane == 31) s.wsum[g >> 5] = x;
  if (lane == 0) s.skip[g >> 5] = skips;
}

// Exclusive sum of v over the block (all threads call it); `total` gets
// the block's sum.  `sh` holds a slot per warp.
__device__ __forceinline__ int32_t block_scan(int32_t v, int32_t* sh,
                                              int32_t& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int32_t x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(kAll, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int32_t w = lane < warps ? sh[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(kAll, w, d);
      if (lane >= d) w += y;
    }
    if (lane < warps) sh[lane] = w;          // inclusive over warps
  }
  __syncthreads();
  const int32_t before = warp ? sh[warp - 1] : 0;
  total = sh[warps - 1];
  __syncthreads();
  return before + x - v;
}

// Phase 3: block b resolves band b of the launch.
__global__ void __launch_bounds__(kResolveThreads)
segment_resolve_kernel(Bands bands, Segs s, int64_t nb,
                       int64_t* __restrict__ starts,
                       int32_t* __restrict__ status) {
  __shared__ int32_t sh[kResolveThreads / 32];
  __shared__ int64_t sh_total;
  const int b = blockIdx.x, t = threadIdx.x;
  const int64_t g0 = bands.seg0[b], w0 = g0 >> 5;
  const int32_t K = bands.K[b], W = (K + 31) >> 5;
  // A contiguous run of the band's warps a thread: their gains and
  // skippers, a block scan of each, then the gains' sums before each warp
  // (in place) and the skippers in order.
  const int32_t chunk = (W + blockDim.x - 1) / blockDim.x;
  const int32_t i0 = min(W, t * chunk), i1 = min(W, i0 + chunk);
  int32_t sum = 0, skips = 0;
  for (int32_t i = i0; i < i1; ++i) {
    sum += s.wsum[w0 + i];
    skips += __popc(s.skip[w0 + i]);
  }
  int32_t gains, n_skip;
  int32_t run = block_scan(sum, sh, gains);
  int32_t at = block_scan(skips, sh, n_skip);
  for (int32_t i = i0; i < i1; ++i) {
    const int32_t v = s.wsum[w0 + i];
    s.wsum[w0 + i] = run;
    run += v;
    for (uint32_t m = s.skip[w0 + i]; m; m &= m - 1)
      s.list[g0 + at++] = 32 * i + __ffs(m) - 1;
  }
  __syncthreads();
  if (t == 0) {
    // The exact walk's jumps: a skipper no earlier jump passed over.
    auto gains_before = [&](int32_t k) {
      return k < K ? s.wsum[(g0 + k) >> 5] + s.pre[g0 + k] : gains;
    };
    int32_t resume = 0, n = 0, passed = 0;
    for (int32_t i = 0; i < n_skip; ++i) {
      const int32_t j = s.list[g0 + i];
      if (j < resume) continue;
      const int32_t l = s.link[g0 + j];
      passed += gains_before(l) - gains_before(j + 1);
      s.jump_from[g0 + n] = j;
      s.jump_to[g0 + n] = l;
      s.jump_entry[g0 + n] = s.entry[g0 + j];
      s.jump_gain[g0 + n] = passed;
      ++n;
      resume = l;
    }
    s.nint[bands.b0 + b] = n;
    const int64_t total = int64_t(s.count[g0]) + gains - passed;
    const int faults = (total != nb) + (s.last_rej[g0] >= bands.first[b]);
    if (faults) atomicAdd(status, faults);
    if (n_skip) atomicAdd(status + 1, n_skip);
    sh_total = total;
  }
  __syncthreads();
  int64_t* __restrict__ out = starts + b * nb;
  for (int64_t i = sh_total + t; i < nb; i += blockDim.x) out[i] = bands.end[b];
}

// Phase 4: a thread a walker on the exact walk writes its starts.
__global__ void __launch_bounds__(kThreads)
segment_write_kernel(const uint8_t* __restrict__ stream, int64_t P,
                     Bands bands, int L, Segs s, int64_t nb,
                     int64_t* __restrict__ starts,
                     int32_t* __restrict__ status) {
  const int64_t g = bands.seg0[0] + int64_t(blockIdx.x) * kThreads +
                    threadIdx.x;
  const int b = bands.band_of(g);
  const int64_t g0 = bands.seg0[b];
  const int32_t k = static_cast<int32_t>(g - g0);
  if (k >= bands.K[b]) return;
  const int64_t first = bands.first[b];
  // The last jump from a walker before this one: passed over it, or the
  // gains it passed over come off the index.
  const int32_t n = s.nint[bands.b0 + b];
  int32_t passed = 0;
  int64_t enter = k ? s.entry[g - 1] : first;
  if (n) {
    int lo = 0, hi = n;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s.jump_from[g0 + mid] < k) lo = mid + 1; else hi = mid;
    }
    if (lo) {
      const int32_t to = s.jump_to[g0 + lo - 1];
      if (k < to) return;
      passed = s.jump_gain[g0 + lo - 1];
      if (k == to) enter = s.jump_entry[g0 + lo - 1];
    }
  }
  if (s.bad[g]) atomicAdd(status, 1);
  int64_t* __restrict__ out = starts + int64_t(b) * nb;
  const int64_t after = int64_t(s.count[g0]) + s.wsum[g >> 5] + s.pre[g] -
                        passed;
  const int64_t seg_first = first + int64_t(k) * s.S;
  const int32_t from = static_cast<int32_t>(enter - seg_first);
  const uint32_t* __restrict__ bits = s.bits + g * s.words;
  int32_t own = 0;
  for (int w = from >> 5; w < s.words; ++w)
    own += __popc(bits[w] & from_mask(w, from));
  int64_t i = after - own;
  for (int w = from >> 5; w < s.words; ++w) {
    for (uint32_t x = bits[w] & from_mask(w, from); x; x &= x - 1) {
      if (i < nb) out[i] = seg_first + 32 * w + __ffs(x) - 1;
      ++i;
    }
  }
  const int32_t nc = s.ncont[g];
  if (nc <= kCont) {
    for (int c = 0; c < nc; ++c, ++i)
      if (i < nb) out[i] = s.cont[g * kCont + c];
    return;
  }
  // More than were kept: the stitch's walk again, from the stop.
  const int64_t end = bands.end[b], e = s.entry[g];
  int64_t p = s.stop[g];
  StreamBits rd = stream_bits(stream, P, p);
  while (p < e) {
    bool ok;
    const int64_t q = step<int64_t>(rd, p, end, L, ok);
    if (ok) {
      if (i < nb) out[i] = p;
      ++i;
    }
    p = q;
  }
}

// The walk kernel may stage up to the card's shared memory; it opts in
// once per device.
cudaError_t opt_in(int device) {
  constexpr int kDevices = 64;
  static std::once_flag once[kDevices];
  static cudaError_t err[kDevices];
  if (device < 0 || device >= kDevices) return cudaErrorInvalidDevice;
  std::call_once(once[device], [device] {
    err[device] = cudaFuncSetAttribute(
        segment_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
  });
  return err[device];
}

}  // namespace

// B bands [firsts[b], ends[b]) of the stream (host arrays: launch
// arguments), nb blocks each, cut into segments of seg_bytes; the walk
// kernel stages its segments and `halo` more bytes.  `scratch` holds
// ops/kernels.py `segment_scratch` int32 entries for G walker slots (each
// band's segments rounded up to kThreads).  Writes the (B * nb,) int64
// starts and the (2,) int32 status.  Bands go kMaxBands to a launch.
JT_API int jt_segment_scan(const void* stream_bytes, int64_t P,
                           const int64_t* firsts, const int64_t* ends,
                           int64_t B, int32_t seg_bytes, int32_t halo,
                           int32_t L, int64_t nb, void* scratch, int64_t G,
                           void* starts, void* status, int32_t device,
                           void* stream) {
  cudaSetDevice(device);
  if (seg_bytes < 32 || seg_bytes % 32 || halo < 0 || halo % 16 || B < 1 ||
      G % kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = opt_in(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s8 = static_cast<const uint8_t*>(stream_bytes);
  const auto st = static_cast<cudaStream_t>(stream);
  int32_t* p = static_cast<int32_t*>(scratch);
  auto take = [&p](int64_t n) {
    int32_t* at = p;
    p += n;
    return at;
  };
  Segs s{};
  for (int32_t** a : {&s.stop, &s.count, &s.last_rej, &s.link, &s.entry,
                      &s.bad, &s.pre, &s.ncont, &s.list, &s.jump_from,
                      &s.jump_to, &s.jump_entry, &s.jump_gain})
    *a = take(G);
  s.cont = take(G * kCont);
  s.words = seg_bytes / 32;
  s.S = seg_bytes;
  s.bits = reinterpret_cast<uint32_t*>(take(G * s.words));
  s.wsum = take(G / 32);
  s.skip = reinterpret_cast<uint32_t*>(take(G / 32));
  s.nint = take(B);
  // A block's segments and the halo, from a first byte rounded down to 16;
  // nothing where that would not fit.
  const int64_t tile = int64_t(kThreads) * seg_bytes + halo + 16;
  const int staged = tile <= kMaxSmem ? static_cast<int>(tile) : 0;
  auto* const out = static_cast<int64_t*>(starts);
  auto* const stat = static_cast<int32_t*>(status);
  int64_t slot = 0;
  for (int64_t b0 = 0; b0 < B; b0 += kMaxBands) {
    Bands bands{};
    bands.n = static_cast<int32_t>(B - b0 < kMaxBands ? B - b0 : kMaxBands);
    bands.b0 = static_cast<int32_t>(b0);
    for (int i = 0; i < bands.n; ++i) {
      const int64_t len = ends[b0 + i] - firsts[b0 + i];
      const int64_t K = len > seg_bytes ? (len + seg_bytes - 1) / seg_bytes
                                        : 1;
      bands.first[i] = firsts[b0 + i];
      bands.end[i] = ends[b0 + i];
      bands.seg0[i] = static_cast<int32_t>(slot);
      bands.K[i] = static_cast<int32_t>(K);
      slot += (K + kThreads - 1) / kThreads * kThreads;
    }
    bands.seg0[bands.n] = static_cast<int32_t>(slot);
    if (slot > G) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned grid = static_cast<unsigned>(
        (slot - bands.seg0[0]) / kThreads);
    segment_walk_kernel<<<grid, kThreads, staged, st>>>(
        s8, P, bands, L, staged, s, stat, b0 == 0);
    segment_stitch_kernel<<<grid, kThreads, 0, st>>>(s8, P, bands, L, s);
    // The resolve and the write index the starts from the launch's first
    // band.
    int64_t* const o = out + b0 * nb;
    segment_resolve_kernel<<<bands.n, kResolveThreads, 0, st>>>(bands, s, nb,
                                                                o, stat);
    segment_write_kernel<<<grid, kThreads, 0, st>>>(s8, P, bands, L, s, nb, o,
                                                    stat);
  }
  return static_cast<int>(cudaGetLastError());
}
