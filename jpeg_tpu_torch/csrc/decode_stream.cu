// K3: block-parallel bitstream decode, stream bytes -> (N, L) levels.
//
// Replaces the Pallas kernel jpeg_tpu/ops/pallas_kernels.py
// `_decode_stream_kernel` (wrapper `decode_stream_rows`).
//
// What it computes: block i starts at byte starts[i] (from the host
// boundary scan, which has already validated the stream).  One code per
// step, at most L + L//15 + 2 steps: the top byte of the next 32 bits is
// run:4 | size:4.  (0, 0) is EOB and ends the block; (15, 0) is a zero-run
// chain and adds 15 to the coefficient index; anything else is a code whose
// amplitude (sign bit 1 = positive, then size-1 magnitude bits) goes to
// index widx + run, which then advances past it.  A code whose index would
// reach L stores nothing and leaves the index where it was, as the TPU
// kernel's `wt < L` gate does.  The output must arrive zero-filled; only
// the nonzero positions are written.
//
// What bounds it on this card: a serial, data-dependent walk per block over
// a few dozen bytes (the stream is a few MB and sits in L2), so it is
// bound by latency per step, not by bandwidth.
//
// What the design does about it: one thread per block reads the stream
// directly at its own start (uint8 stream, int64 offsets) through a 40-bit
// window, so no block waits for another and no per-block rows are built.
// The TPU forms (the overlap table and its row gather, the alignment
// prologue, little-endian word upload, the length sort that evened out
// lockstep tiles) are gone: threads that finish early simply retire.
// Reads past the stream end see zero bytes, which decode as EOB, so starts
// from a boundary scan that failed its check (up to one past the end) are
// safe to decode before the check is read.
#include "common.cuh"

namespace {

__global__ void decode_stream_kernel(const uint8_t* __restrict__ stream,
                                     int64_t nbytes,
                                     const int64_t* __restrict__ starts,
                                     int64_t n, int L,
                                     int32_t* __restrict__ out) {
  const int max_steps = L + L / jt::kMaxRun + 2;
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * blockDim.x) {
    int32_t* o = out + i * L;
    int64_t pos = starts[i] * 8;
    int widx = 0;
    for (int step = 0; step < max_steps; ++step) {
      const uint32_t win = jt::peek32(stream, nbytes, pos);
      const int run = static_cast<int>(win >> 28);
      const int size = static_cast<int>((win >> 24) & 0xF);
      if (size == 0 && run == 0) break;                 // EOB
      if (size == 0 && run == jt::kMaxRun) {            // zero-run chain
        widx += jt::kMaxRun;
        pos += 8;
        continue;
      }
      const int nmag = size > 0 ? size - 1 : 0;
      const int32_t mag = static_cast<int32_t>(
          (win >> (23 - nmag)) & ((1u << nmag) - 1u));
      const int32_t amp = ((win >> 23) & 1u) ? mag : -mag;
      const int wt = widx + run;
      if (wt < L) {
        o[wt] = amp;
        widx = wt + 1;
      }
      pos += 8 + size;
    }
  }
}

}  // namespace

JT_API int jt_decode_stream(const void* stream_bytes, int64_t nbytes,
                            const void* starts, int64_t n, int32_t L,
                            void* out, int32_t device, void* stream) {
  cudaSetDevice(device);
  const int threads = 128;
  decode_stream_kernel<<<jt::grid_for(n, threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(stream_bytes), nbytes,
      static_cast<const int64_t*>(starts), n, L,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
