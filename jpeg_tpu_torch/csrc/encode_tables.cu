// K9: per-block bitstream encode from unit-group tables -> big-endian
// stream-word rows.
//
// Replaces the Pallas kernel jpeg_tpu/ops/pallas_kernels.py
// `_encode_stream_kernel` (wrapper `encode_stream_rows`).
//
// What it computes: the tables come from entropy/device_codec.py
// `_unit_groups`: slot s of block i appends cbits[i, s] bits of the value
// (vhi << 32) | vlo, MSB first; a slot is its zero-run chain bytes (0xF0)
// followed by its run/size/sign/magnitude code, at most 55 bits, and slot L
// is the EOB byte plus the pad to a byte.  Zero slots inside a run have
// cbits = 0 and append nothing.  Row i holds the block's bytes
// top-justified in big-endian 32-bit words, zero-padded to W words: the
// same rows as K1 (encode_stream.cu) writes from the levels.  A block longer
// than 4 * W bytes is truncated in its row and the caller's overflow check
// (device_codec.encode_stream_sized) raises.  cbits is read clamped to
// [0, 64].
//
// What bounds it on this card: memory traffic.  The rows depend on cbits
// in full (4 bytes per slot, as K1 reads 4 per level), on vlo only at the
// slots that code something and on vhi only at groups of more than 32
// bits; the rows are written once.  One thread a block read each table
// 4 * (L + 1) bytes apart across a warp, waited on each load in turn, and
// stored its row a word at a time at a 4 * W stride.
//
// What the design does about it: K1's writer (bit_writer.cuh) and plan.
// The tile's cbits and vlo arrive in shared memory by coalesced
// asynchronous copies: a lane fetching the low words of its coded slots
// from global memory itself touched a 32-byte sector a word, which cost
// more than copying all of vlo; vhi, needed only by the rare groups past
// 32 bits, is read where it lies.  Lane k of a block's group owns m =
// ceil((L + 1) / G) consecutive slots and walks only its coded ones (32
// slots at a time into a mask); their lengths are its bit count, so one
// sum-scan over the group gives each lane its first bit (one lane a block,
// the main path's plan, writes as it counts).  A group of c > 32 bits goes
// in as its high c - 32 bits, then its low 32.  The row is staged in
// shared memory and leaves coalesced, zeros included.  What the TPU
// kernel did for its layout is gone: the transposed lane layout, the
// funnel shifts of a bottom-justified word column and the closing
// top-justify.
#include "bit_writer.cuh"

namespace {

__device__ __forceinline__ uint32_t low_bits(uint32_t v, int n) {
  return n >= 32 ? v : v & ((1u << n) - 1u);
}

struct Coded {
  __device__ bool operator()(int32_t c) const { return c > 0; }
};

template <int G>
__global__ void __launch_bounds__(jt::kEncThreads)
encode_tables_kernel(const int32_t* __restrict__ cbits,
                     const int32_t* __restrict__ vhi,
                     const int32_t* __restrict__ vlo, int64_t n, int L1,
                     int W, int tile, bool smem_rows, bool vec_out,
                     uint32_t* __restrict__ rows) {
  extern __shared__ int4 smem[];
  jt::EncTile t(smem, tile, L1, W, smem_rows);
  const int64_t i0 = int64_t(blockIdx.x) * tile;
  const int nb = n - i0 < tile ? static_cast<int>(n - i0) : tile;
  t.stage(t.table, cbits + i0 * L1, nb, L1);
  t.stage(t.values, vlo + i0 * L1, nb, L1);
  jt::EncTile::wait_staged();
  if (smem_rows) jt::zero_words(t.rows, tile * W);
  __syncthreads();

  const int lane = threadIdx.x % G;
  const int m = (L1 + G - 1) / G;
  const int s0 = min(lane * m, L1), s1 = min(s0 + m, L1);
  for (int b = threadIdx.x / G; b < tile; b += blockDim.x / G) {
    const bool live = b < nb;
    const int32_t* cb = t.table + b * t.stride;
    const int32_t* lo_s = t.values + b * t.stride;
    uint32_t* row = smem_rows ? t.rows + b * W : rows + (i0 + b) * W;
    if (!smem_rows) {
      if (live)
        for (int k = lane; k < W; k += G) row[k] = 0;
      __syncwarp();
    }
    // The lane's first bit: a sum-scan of the lanes' lengths (0 for one
    // lane a block, which writes as it counts).
    int bit0 = 0, bits = 0;
    if (G > 1) {
      if (live)
        jt::for_each_kept(cb, s0, s1, Coded(),
                          [&](int s) { bits += min(cb[s], 64); });
      bit0 = jt::group_sum<G>(bits, lane) - bits;
    }
    if (live && (G == 1 || bits > 0)) {
      const int64_t base = (i0 + b) * L1;
      jt::LaneWriter lw(row, W, bit0);
      jt::for_each_kept(cb, s0, s1, Coded(), [&](int s) {
        const int c = min(cb[s], 64);
        const uint32_t lo = static_cast<uint32_t>(lo_s[s]);
        if (c > 32) {
          lw.append(c - 32,
                    low_bits(static_cast<uint32_t>(vhi[base + s]), c - 32));
          lw.append(32, lo);
        } else {
          lw.append(c, low_bits(lo, c));
        }
      });
      lw.finish();
    }
  }
  __syncthreads();
  if (smem_rows) jt::store_words(rows + i0 * W, t.rows, nb * W, vec_out);
}

using Kernel = void (*)(const int32_t*, const int32_t*, const int32_t*,
                        int64_t, int, int, int, bool, bool, uint32_t*);
const Kernel kKernels[] = {encode_tables_kernel<1>, encode_tables_kernel<4>,
                           encode_tables_kernel<8>, encode_tables_kernel<16>,
                           encode_tables_kernel<32>};

}  // namespace

JT_API int jt_encode_tables(const void* cbits, const void* vhi,
                            const void* vlo, int64_t n, int32_t L1, int32_t W,
                            int32_t lanes, int32_t tile, int32_t smem_rows,
                            void* rows, int32_t device, void* stream) {
  cudaSetDevice(device);
  const bool vec_out = reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
                       (int64_t(tile) * W) % 4 == 0;
  return jt::enc_run(kKernels, 2, n, L1, W, lanes, tile, smem_rows != 0,
                     stream,
                     static_cast<const int32_t*>(cbits),
                     static_cast<const int32_t*>(vhi),
                     static_cast<const int32_t*>(vlo), n, L1, W, tile,
                     smem_rows != 0, vec_out, static_cast<uint32_t*>(rows));
}
