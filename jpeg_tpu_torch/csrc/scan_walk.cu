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
// whole unit budget, and the slowest lane sets its warp's time.  The reads
// are a few bytes near each thread's own position, which neighbouring
// threads share through L1, so it is bound by the units walked per warp,
// not by bandwidth.
//
// What the design does about it: one thread per walker reads the stream at
// its own bit position through K3's 40-bit window (common.cuh peek32) and
// retires as soon as its walk ends; both entries run one walk function, so
// a resumed walker continues exactly where the capped one stopped.
// Because each thread reads at its own position, a resume needs no row
// gather: it starts at bit 8 * q + c0.  Positions are int64, so
// pos + 8 + size never wraps.  The TPU forms (the overlap-table rows, the
// alignment prologue, the funnel shifts and the lockstep tile that waits
// for its slowest column) are gone.
#include "common.cuh"

namespace {

enum : int { kLive = 0, kDone = 1, kErr = 2 };

// Walk one block from bit `pos` with coefficient index `widx` for at most
// `units` units.  Returns kDone (pos at the EOB header), kErr (pos and widx
// where the rejected unit starts) or kLive (the unit budget ran out).
__device__ __forceinline__ int walk(const uint8_t* __restrict__ stream,
                                    int64_t P, int64_t limit, int L,
                                    int units, int64_t& pos, int& widx) {
  for (int unit = 0; unit < units; ++unit) {
    if (pos + 8 > limit) return kErr;                 // truncated header
    const uint32_t h = jt::peek32(stream, P, pos) >> 24;
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

__global__ void scan_walk_kernel(const uint8_t* __restrict__ stream,
                                 int64_t P, int64_t limit, int L,
                                 int32_t* __restrict__ E) {
  const int32_t err = static_cast<int32_t>(P + 1);
  for (int64_t q = blockIdx.x * int64_t(blockDim.x) + threadIdx.x;
       q < P + 2; q += int64_t(gridDim.x) * blockDim.x) {
    int32_t end = err;
    if (q < P) {
      int64_t pos = q * 8;
      int widx = 0;
      if (walk(stream, P, limit, L, max_units(L), pos, widx) == kDone)
        end = static_cast<int32_t>((pos + 15) >> 3);   // EOB: pad to a byte
    }
    E[q] = end;
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
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < M;
       i += int64_t(gridDim.x) * blockDim.x) {
    const int c_in = c0 ? c0[i] : 0;
    int widx = w0 ? w0[i] : 0;
    int32_t out = -2;
    int64_t pos = 0;
    if (i < live) {
      const int64_t start = q[i] * 8;
      pos = start + c_in;
      const int st = walk(stream, P, limit, L, cap, pos, widx);
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
