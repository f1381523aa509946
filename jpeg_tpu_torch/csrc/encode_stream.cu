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
// neighbouring fields or overflow the bit accumulator).
//
// What bounds it on this card: per block the work is a serial walk over L
// levels with data-dependent branching, and the data is small (4 bytes in
// per level, a few bits out), so it is bound by memory latency and by the
// serial chain per thread, not by bandwidth or arithmetic.
//
// What the design does about it: one thread per block, so the serial walk
// runs in registers: the bits accumulate in a 64-bit register and leave as
// whole 32-bit words (bit_writer.cuh, shared with K9), with no shared state
// between threads and no synchronisation.  `size` comes from __clz.  Zero runs of any length are
// written one chain byte at a time, so any L is handled (the TPU kernel's
// extra appends for runs over 74 zeros are not needed).  The TPU layout
// (in-VMEM transposes, the funnel-shift append ladder, the f32-exponent
// size trick) is gone.  A row never grows past W words: the kernel counts
// the bytes of a longer block but does not store them, and the caller
// checks blk_bytes <= 4*W and raises.
#include "bit_writer.cuh"

namespace {

__global__ void encode_rows_kernel(const int32_t* __restrict__ levels,
                                   int64_t n, int L, int W,
                                   uint32_t* __restrict__ rows,
                                   int32_t* __restrict__ blk_bytes) {
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * blockDim.x) {
    const int32_t* lv = levels + i * L;
    jt::BitWriter bw(rows + i * W, W);
    int prev = -1;
    for (int s = 0; s < L; ++s) {
      int32_t a = lv[s];
      if (a == 0) continue;
      uint32_t absa = a < 0 ? 0u - static_cast<uint32_t>(a)
                            : static_cast<uint32_t>(a);
      int size = 33 - __clz(absa);                   // bit_length + 1
      if (size > jt::kMaxSize) size = jt::kMaxSize;
      int run = s - prev - 1;
      int nch = run / jt::kMaxRun;
      uint32_t rrem = static_cast<uint32_t>(run - nch * jt::kMaxRun);
      for (int c = 0; c < nch; ++c) bw.append(8, 0xF0u);
      uint32_t mag = absa & ((1u << (size - 1)) - 1u);
      uint32_t code = (rrem << (4 + size))
                      | (static_cast<uint32_t>(size) << size)
                      | (static_cast<uint32_t>(a > 0) << (size - 1)) | mag;
      bw.append(8 + size, code);
      prev = s;
    }
    bw.append(8, 0u);                                // EOB
    bw.append(static_cast<int>((-bw.total) & 7), 0u);  // pad to a byte
    bw.finish();
    blk_bytes[i] = static_cast<int32_t>(bw.total >> 3);
  }
}

}  // namespace

JT_API int jt_encode_rows(const void* levels, int64_t n, int32_t L,
                          int32_t W, void* rows, void* blk_bytes,
                          int32_t device, void* stream) {
  cudaSetDevice(device);
  const int threads = 128;
  encode_rows_kernel<<<jt::grid_for(n, threads), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(levels), n, L, W,
      static_cast<uint32_t*>(rows), static_cast<int32_t*>(blk_bytes));
  return static_cast<int>(cudaGetLastError());
}

JT_API const char* jt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
