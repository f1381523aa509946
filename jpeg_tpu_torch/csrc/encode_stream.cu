// K1: per-block bitstream encode, levels -> big-endian stream-word rows.
//
// Replaces the Pallas kernel jpeg_tpu/ops/pallas_kernels.py
// `_encode_stream_lv_kernel` (wrapper `encode_stream_rows_lv`).
//
// What it computes: for block i (one row of L zigzag int32 levels), every
// nonzero amplitude a preceded by r zeros emits r // 15 zero-run chain bytes
// 0xF0, then the code  (r % 15):4 | size:4 | sign:1 | |a|:(size-1)  with
// size = min(bit_length(|a|) + 1, 15) and sign bit 1 = positive.  An 8-bit
// EOB and zero padding to the next byte end the block.  Row i holds the
// block's bytes top-justified in big-endian 32-bit words (byte 0 in bits
// 31..24 of word 0), zero-padded to W words; blk_bytes[i] is its length.
// Levels must satisfy |a| <= 16383: the caller rejects larger ones first
// (the magnitude is masked to size-1 bits so such input cannot corrupt the
// neighbouring fields or overflow the bit accumulator).  A block longer
// than 4 * W bytes is truncated in its row and its blk_bytes stays exact:
// the caller checks blk_bytes <= 4 * W and raises.
//
// What bounds it on this card: its bytes, 4 * N * (L + W + 1) (15 MB at the
// 2048x2048 main path: 0.0045 ms at 3.35 TB/s), and the dependent chain of
// a block's codes.  One thread a block walking its L levels in order from
// global memory read them 4 * L bytes apart across a warp, waited on each
// load in turn, stored its row a word at a time at a 4 * W stride, zeroed
// the row's tail alone, and ran an L-step chain with data-dependent
// branches that diverged across the warp's 32 blocks.
//
// What the design does about it (bit_writer.cuh): a thread block's tile of
// blocks has its levels copied to shared memory, coalesced and
// asynchronous, and its rows staged there and stored coalesced, zeros and
// block bytes included: no memset, one launch.  A group of G lanes writes
// one block, lane k owning m = ceil(L / G) consecutive levels, and each
// lane walks only its nonzeros (32 levels at a time into a mask).  G (1,
// 4, 8, 16 or 32) comes from how many blocks there are and how long they
// are (ops/kernels.py `encode_rows_plan`): at the main path's 49,152
// blocks one lane a block already fills the card and writes as it counts;
// at d = 24's 1,452 blocks of 576 levels a warp a block splits each walk
// 32 ways.  For G > 1, pass 1: each lane finds
// its nonzeros, their sizes (__clz) and its last nonzero; an inclusive
// max-scan of "last nonzero" over the group gives each lane `prev`, the
// last nonzero before its first level, so the zero run of its first
// nonzero (and its 0xF0 chain bytes, however many lanes the run crosses)
// is known; the lane's bit count is sum(8 chains + 8 + size) over its
// nonzeros, and a sum-scan gives its first bit and the block's length (+ 8
// EOB bits, padded to a byte: the EOB and the pad are zero bits of the
// zeroed row).  Pass 2: each lane writes its chain bytes (as pieces of up
// to 32 bits) and codes from its first bit.
#include "bit_writer.cuh"

namespace {

__device__ __forceinline__ int code_size(uint32_t absa) {
  return min(33 - __clz(absa), jt::kMaxSize);           // bit_length + 1
}

__device__ __forceinline__ uint32_t magnitude(int32_t a) {
  return a < 0 ? 0u - static_cast<uint32_t>(a) : static_cast<uint32_t>(a);
}

struct Nonzero {
  __device__ bool operator()(int32_t a) const { return a != 0; }
};

// Append the chain bytes and codes of the levels lv[s0, s1), the last
// nonzero before s0 being `prev` (left at the last one appended).
__device__ __forceinline__ void write_codes(jt::LaneWriter& lw,
                                            const int32_t* lv, int s0,
                                            int s1, int& prev) {
  jt::for_each_kept(lv, s0, s1, Nonzero(), [&](int s) {
    const int32_t a = lv[s];
    const uint32_t absa = magnitude(a);
    const int size = code_size(absa);
    const int run = s - prev - 1;
    int nch = run / jt::kMaxRun;
    const uint32_t rrem = static_cast<uint32_t>(run - nch * jt::kMaxRun);
    for (; nch >= 4; nch -= 4) lw.append(32, 0xF0F0F0F0u);
    if (nch > 0) lw.append(8 * nch, 0xF0F0F0F0u >> (32 - 8 * nch));
    const uint32_t mag = absa & ((1u << (size - 1)) - 1u);
    lw.append(8 + size, (rrem << (4 + size))
                            | (static_cast<uint32_t>(size) << size)
                            | (static_cast<uint32_t>(a > 0) << (size - 1))
                            | mag);
    prev = s;
  });
}

// One lane a block, a block a thread: it starts at bit 0, so it writes its
// row as it counts, in one pass.
__device__ __forceinline__ void rows_one_lane(const jt::EncTile& t, int nb,
                                              int L, int W, bool smem_rows,
                                              uint32_t* __restrict__ rows) {
  const int b = threadIdx.x;
  if (b >= nb) return;
  uint32_t* row = smem_rows ? t.rows + b * W : rows + int64_t(b) * W;
  if (!smem_rows)
    for (int k = 0; k < W; ++k) row[k] = 0;
  jt::LaneWriter lw(row, W, 0);
  int prev = -1;
  write_codes(lw, t.table + b * t.stride, 0, L, prev);
  t.bytes[b] = (lw.bits() + 8 + 7) >> 3;
  lw.finish();
}

// G > 1 lanes a block, the tile's levels staged: pass 1 counts each lane's
// bits, the scans place them, pass 2 writes them.
template <int G>
__device__ __forceinline__ void rows_by_groups(
    const jt::EncTile& t, int64_t i0, int nb, int tile, int L, int W,
    bool smem_rows, uint32_t* __restrict__ rows) {
  const int lane = threadIdx.x % G;
  const int m = (L + G - 1) / G;
  const int s0 = min(lane * m, L), s1 = min(s0 + m, L);
  // Every lane of a warp runs the same iterations (tile is a multiple of
  // the groups), so the group's shuffles see all of its lanes.
  for (int b = threadIdx.x / G; b < tile; b += blockDim.x / G) {
    const bool live = b < nb;
    const int32_t* lv = t.table + b * t.stride;
    uint32_t* row = smem_rows ? t.rows + b * W : rows + (i0 + b) * W;
    if (!smem_rows) {
      if (live)
        for (int k = lane; k < W; k += G) row[k] = 0;
      __syncwarp();
    }
    // Pass 1: the lane's bits, but for its first nonzero's zero run.
    int last = -1, first = -1, first_size = 0, bits = 0;
    if (live) {
      jt::for_each_kept(lv, s0, s1, Nonzero(), [&](int s) {
        const int size = code_size(magnitude(lv[s]));
        if (first < 0) {
          first = s;
          first_size = size;
        } else {
          bits += 8 * ((s - last - 1) / jt::kMaxRun) + 8 + size;
        }
        last = s;
      });
    }
    const int prev = jt::group_before<G>(jt::group_max<G>(last, lane), lane,
                                         -1);
    if (first >= 0)
      bits += 8 * ((first - prev - 1) / jt::kMaxRun) + 8 + first_size;
    const int incl = jt::group_sum<G>(bits, lane);
    const int total = jt::group_last<G>(incl);
    // Pass 2: deposit from the lane's first bit.
    if (live && bits > 0) {
      jt::LaneWriter lw(row, W, incl - bits);
      int p = prev;
      write_codes(lw, lv, s0, s1, p);
      lw.finish();
    }
    if (live && lane == 0) t.bytes[b] = (total + 8 + 7) >> 3;
  }
}

template <int G>
__global__ void __launch_bounds__(jt::kEncThreads)
encode_rows_kernel(const int32_t* __restrict__ levels, int64_t n, int L,
                   int W, int tile, bool smem_rows, bool vec_out,
                   uint32_t* __restrict__ rows,
                   int32_t* __restrict__ blk_bytes) {
  extern __shared__ int4 smem[];
  jt::EncTile t(smem, tile, L, W, smem_rows);
  const int64_t i0 = int64_t(blockIdx.x) * tile;
  const int nb = n - i0 < tile ? static_cast<int>(n - i0) : tile;
  t.stage(t.table, levels + i0 * L, nb, L);
  jt::EncTile::wait_staged();
  if (smem_rows) jt::zero_words(t.rows, tile * W);
  __syncthreads();
  if (G == 1) {
    rows_one_lane(t, nb, L, W, smem_rows, rows + i0 * W);
  } else {
    rows_by_groups<G>(t, i0, nb, tile, L, W, smem_rows, rows);
  }
  __syncthreads();
  if (smem_rows) jt::store_words(rows + i0 * W, t.rows, nb * W, vec_out);
  for (int b = threadIdx.x; b < nb; b += blockDim.x)
    blk_bytes[i0 + b] = t.bytes[b];
}

using Kernel = void (*)(const int32_t*, int64_t, int, int, int, bool, bool,
                        uint32_t*, int32_t*);
const Kernel kKernels[] = {encode_rows_kernel<1>, encode_rows_kernel<4>,
                           encode_rows_kernel<8>, encode_rows_kernel<16>,
                           encode_rows_kernel<32>};

}  // namespace

JT_API int jt_encode_rows(const void* levels, int64_t n, int32_t L,
                          int32_t W, int32_t lanes, int32_t tile,
                          int32_t smem_rows, void* rows, void* blk_bytes,
                          int32_t device, void* stream) {
  cudaSetDevice(device);
  const bool vec_out = reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
                       (int64_t(tile) * W) % 4 == 0;
  return jt::enc_run(kKernels, 1, n, L, W, lanes, tile, smem_rows != 0,
                     stream,
                     static_cast<const int32_t*>(levels), n, L, W, tile,
                     smem_rows != 0, vec_out, static_cast<uint32_t*>(rows),
                     static_cast<int32_t*>(blk_bytes));
}

JT_API const char* jt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
