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
// (device_codec.encode_stream_sized) raises.  cbits must lie in [0, 64]:
// larger values are read as 64.
//
// What bounds it on this card: memory traffic.  cbits is read in full (4
// bytes per slot, as K1 reads 4 per level); vlo only at the slots that
// code something and vhi only at groups of more than 32 bits.  Per block
// the appends are a serial chain in registers.
//
// What the design does about it: one thread per block with K1's 64-bit bit
// accumulator (bit_writer.cuh): a group of c > 32 bits goes in as its high
// c - 32 bits, then its low 32; words leave the accumulator as they fill.
// What the TPU kernel did for its layout is gone: the transposed lane
// layout, the funnel shifts of a bottom-justified word column and the
// closing top-justify.
#include "bit_writer.cuh"

namespace {

__device__ __forceinline__ uint32_t low_bits(uint32_t v, int n) {
  return n >= 32 ? v : v & ((1u << n) - 1u);
}

__global__ void encode_tables_kernel(const int32_t* __restrict__ cbits,
                                     const int32_t* __restrict__ vhi,
                                     const int32_t* __restrict__ vlo,
                                     int64_t n, int L1, int W,
                                     uint32_t* __restrict__ rows) {
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * blockDim.x) {
    const int64_t base = i * L1;
    jt::BitWriter bw(rows + i * W, W);
    for (int s = 0; s < L1; ++s) {
      const int c = min(cbits[base + s], 64);
      if (c <= 0) continue;
      const uint32_t lo = static_cast<uint32_t>(vlo[base + s]);
      if (c > 32) {
        bw.append(c - 32,
                  low_bits(static_cast<uint32_t>(vhi[base + s]), c - 32));
        bw.append(32, lo);
      } else {
        bw.append(c, low_bits(lo, c));
      }
    }
    bw.finish();
  }
}

}  // namespace

JT_API int jt_encode_tables(const void* cbits, const void* vhi,
                            const void* vlo, int64_t n, int32_t L1, int32_t W,
                            void* rows, int32_t device, void* stream) {
  cudaSetDevice(device);
  const int threads = 128;
  encode_tables_kernel<<<jt::grid_for(n, threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cbits), static_cast<const int32_t*>(vhi),
      static_cast<const int32_t*>(vlo), n, L1, W,
      static_cast<uint32_t*>(rows));
  return static_cast<int>(cudaGetLastError());
}
