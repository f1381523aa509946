// K6: speculative boundary-scan walkers, stream bytes -> end table.
//
// Replaces the Pallas kernel jpeg_tpu/ops/pallas_kernels.py
// `_scan_walk_kernel_single` (the single-sweep form of `_scan_walk_kernel`,
// CAP = 0; wrapper `scan_walk_rows`).
//
// What it computes: for every byte q < P of the stream buffer, E[q] is the
// end byte of "the block that starts at q", walked with the host scanner's
// rules (jpeg_tpu/entropy/native/entropy.cpp `jt_scan_offsets`), or
// ERR = P + 1 wherever the host scanner would reject the block: a header
// that runs past `limit` bits, a (run, 0) code with run not in {0, 15}, a
// code whose magnitude runs past `limit`, a coefficient index widx + run
// >= L, or no EOB within L + L/15 + 2 units.  EOB pads to the next byte; a
// zero-run chain (0xF0) adds 15 to the index unchecked, as the host scanner
// does.  E[P] = E[P + 1] = ERR, so ERR absorbs in the orbit chase (K7, K8).
// `limit` is 8 * n_bytes: in a buffer of several bands a walker may run
// across a band boundary, and the chase's per-band end check rejects that.
//
// What bounds it on this card: one serial, data-dependent walk per byte.
// Most walkers settle within a few units, a garbage walker may take the
// whole unit budget, and the slowest lane sets its warp's time.  The reads
// are a few bytes near each thread's own position, which neighbouring
// threads share through L1, so it is bound by the units walked per warp,
// not by bandwidth.
//
// What the design does about it: one thread per byte position reads the
// stream at its own bit position through K3's 40-bit window
// (common.cuh peek32) and retires as soon as its walk ends.  Positions are
// int64, so pos + 8 + size never wraps.  The TPU forms (the overlap-table
// rows, the alignment prologue, the funnel shifts and the lockstep tile
// that waits for its slowest column) are gone.
#include "common.cuh"

namespace {

__global__ void scan_walk_kernel(const uint8_t* __restrict__ stream,
                                 int64_t P, int64_t limit, int L,
                                 int32_t* __restrict__ E) {
  const int max_units = L + L / jt::kMaxRun + 2;
  const int32_t err = static_cast<int32_t>(P + 1);
  for (int64_t q = blockIdx.x * int64_t(blockDim.x) + threadIdx.x;
       q < P + 2; q += int64_t(gridDim.x) * blockDim.x) {
    int32_t end = err;
    if (q < P) {
      int64_t pos = q * 8;
      int widx = 0;
      for (int unit = 0; unit < max_units; ++unit) {
        if (pos + 8 > limit) break;                     // truncated header
        const uint32_t h = jt::peek32(stream, P, pos) >> 24;
        if (h == 0) {                                   // EOB: pad to a byte
          end = static_cast<int32_t>((pos + 15) >> 3);
          break;
        }
        if (h == 0xF0) {                                // zero-run chain
          widx += jt::kMaxRun;
          pos += 8;
          continue;
        }
        const int run = static_cast<int>(h >> 4);
        const int size = static_cast<int>(h & 0xF);
        if (size == 0) break;                           // (run, 0) code
        if (pos + 8 + size > limit) break;              // truncated code
        if (widx + run >= L) break;                     // index overflow
        widx += run + 1;
        pos += 8 + size;
      }
    }
    E[q] = end;
  }
}

}  // namespace

JT_API int jt_scan_walk(const void* stream_bytes, int64_t P, int64_t limit,
                        int32_t L, void* end_table, int32_t device,
                        void* stream) {
  cudaSetDevice(device);
  const int threads = 256;
  scan_walk_kernel<<<jt::grid_for(P + 2, threads), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(stream_bytes), P, limit, L,
      static_cast<int32_t*>(end_table));
  return static_cast<int>(cudaGetLastError());
}
