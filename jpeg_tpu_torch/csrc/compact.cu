// K2: stream compaction by positioned deposit, rows -> contiguous stream.
//
// Replaces the Pallas kernel jpeg_tpu/ops/pallas_kernels.py
// `_merge_rows_kernel` (wrapper `merge_rows_units`, nine rounds of pairwise
// byte-exact row concatenation) together with the grouped row gather that
// followed it in jpeg_tpu/entropy/device_codec.py `compact_rows`.
//
// What it computes: given block i's stream row (big-endian words from K1),
// its byte count blk_bytes[i] and its exclusive byte offset offsets[i] (a
// prefix sum the wrapper takes with torch.cumsum in int64), write the row's
// first blk_bytes[i] bytes to out[offsets[i] ...].  The result is the
// concatenated band stream.  Nothing past `cap` bytes is written.
//
// What bounds it on this card: pure data movement, one read of the rows and
// one write of the stream, so device-memory bandwidth (and for a few-MB
// stream, launch latency).
//
// What the design does about it: phase 1 already knows every block's
// length, so every byte's destination is known up front and one pass moves
// it; the TPU needed the merge rounds and the gather only because it lacks
// cheap dynamic stores.  One thread per (block, word): neighbouring threads
// read neighbouring words of a row (coalesced) and write neighbouring bytes.
// Blocks are byte-aligned (each ends with an EOB padded to a byte), so
// every output byte has exactly one writer and plain byte stores are
// race-free; no atomics are needed.
#include "common.cuh"

namespace {

__global__ void deposit_kernel(const uint32_t* __restrict__ rows,
                               const int32_t* __restrict__ blk_bytes,
                               const int64_t* __restrict__ offsets,
                               int64_t n, int W, uint8_t* __restrict__ out,
                               int64_t cap) {
  const int64_t work = n * W;
  for (int64_t t = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; t < work;
       t += int64_t(gridDim.x) * blockDim.x) {
    const int64_t i = t / W;
    const int b0 = 4 * static_cast<int>(t - i * W);
    const int bb = blk_bytes[i];
    if (b0 >= bb) continue;
    const uint32_t w = rows[t];
    const int64_t dst = offsets[i] + b0;
    const int nb = bb - b0 < 4 ? bb - b0 : 4;
    for (int j = 0; j < nb; ++j) {
      if (dst + j < cap) out[dst + j] = static_cast<uint8_t>(w >> (24 - 8 * j));
    }
  }
}

}  // namespace

JT_API int jt_deposit_rows(const void* rows, const void* blk_bytes,
                           const void* offsets, int64_t n, int32_t W,
                           void* out, int64_t cap, int32_t device,
                           void* stream) {
  cudaSetDevice(device);
  const int threads = 256;
  deposit_kernel<<<jt::grid_for(n * W, threads), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows),
      static_cast<const int32_t*>(blk_bytes),
      static_cast<const int64_t*>(offsets), n, W,
      static_cast<uint8_t*>(out), cap);
  return static_cast<int>(cudaGetLastError());
}
