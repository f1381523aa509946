// K7 and K8: the orbit chase of the boundary scan, end table -> starts.
//
// Replace the Pallas kernels jpeg_tpu/ops/pallas_kernels.py `_chase_kernel`
// (wrapper `chase_starts`; K7, one chain) and `_chase_multi_kernel`
// (wrapper `chase_starts_multi`; K8, one chain per band of a container).
//
// What they compute: given K6's end table E (P2 = P + 2 entries, ERR =
// P + 1 absorbing), a chain from s0 records starts[0] = s0 and
// starts[b + 1] = E[starts[b]] for nb starts; ok = (E[starts[nb - 1]] ==
// target), the chain's end offset.  Positions are clamped to [0, P2 - 1]
// before they index E, so ERR absorbs; E's entries must lie in that range,
// as K6's do.  Starts are int64 (what K3 takes).
//
// What bounds them on this card: nb dependent loads per chain, each waiting
// for the last.  E is 4 bytes per stream byte (5.6 MB at 2048x2048), far
// beyond a block's 227 KB of shared memory, so a chain read straight from
// E would pay a full L2 latency per block start.
//
// What the design does about it: one thread block per chain.  The chain
// only moves forward (E[q] > q), so the block stages windows of kWindow
// entries of E into shared memory with coalesced loads, and one thread
// follows the chain inside the current window at shared-memory latency
// while the block's other warps stage the window after it.  The chain
// leaves a window a few entries past its end, so it almost always goes on
// in the staged one; only a jump past that restages where the chain went.
// A window of 4096 entries holds about a hundred blocks' starts of a
// typical stream.  The TPU forms (the whole table resident in VMEM behind
// a size gate, the 128-lane packed start rows, the one-hot lane reduce per
// step) are gone.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWindow = 4096;   // int32 entries: 2 x 16 KB of shared memory

__device__ __forceinline__ int32_t clamp_to(int64_t v, int32_t hi) {
  return static_cast<int32_t>(v < 0 ? 0 : (v > hi ? hi : v));
}

// Threads [first, blockDim.x) copy E[base, base + kWindow) (clipped to P2)
// into `win`, clamped to [0, P2 - 1]; the unrolled loop keeps several
// loads in flight per thread.
__device__ __forceinline__ void stage(int32_t* __restrict__ win,
                                      const int32_t* __restrict__ E,
                                      int32_t P2, int32_t base, int first) {
  const int stride = blockDim.x - first;
#pragma unroll 4
  for (int t = threadIdx.x - first; t < kWindow; t += stride) {
    if (base + t < P2) win[t] = clamp_to(E[base + t], P2 - 1);
  }
}

// Follows one chain; every thread of the block calls it.  Returns the
// chain's end.  Positions after the first are entries of E, so the loop
// runs in int32 (the wrapper bounds P2) with one unsigned window test per
// step.
__device__ int64_t chase_chain(const int32_t* __restrict__ E, int32_t P2,
                               int64_t s0, int32_t nb,
                               int64_t* __restrict__ starts) {
  __shared__ int32_t win[2][kWindow];
  // Thread 0 publishes its state here; two slots, by round parity, so it
  // never overwrites a slot that another thread has still to read.
  __shared__ int32_t sh_pos[2], sh_done[2];
  if (nb == 0) return s0;
  // Chase from the clamped s0 (the same chain), record s0 itself at the end.
  int32_t pos = clamp_to(s0, P2 - 1);
  int32_t done = 0;
  int32_t base = pos;
  int cur = 0;
  stage(win[cur], E, P2, base, 0);
  __syncthreads();
  for (int round = 0;; ++round) {
    const int32_t next = base + kWindow;
    if (threadIdx.x == 0) {
      const int32_t* __restrict__ w = win[cur];
      uint32_t c = static_cast<uint32_t>(pos - base);
      while (done < nb && c < kWindow) {   // until it leaves the window
        starts[done++] = pos;
        pos = w[c];
        c = static_cast<uint32_t>(pos - base);
      }
      sh_pos[round & 1] = pos;
      sh_done[round & 1] = done;
    } else if (threadIdx.x >= 32) {
      stage(win[cur ^ 1], E, P2, next, 32);
    }
    __syncthreads();
    pos = sh_pos[round & 1];
    done = sh_done[round & 1];
    if (done >= nb) {
      if (threadIdx.x == 0) starts[0] = s0;
      return pos;
    }
    if (static_cast<uint32_t>(pos - next) < kWindow) {  // in the staged one
      base = next;
      cur ^= 1;
    } else {                                           // elsewhere: restage
      base = pos;
      stage(win[cur], E, P2, base, 0);
      __syncthreads();
    }
  }
}

__global__ void chase_kernel(const int32_t* __restrict__ E, int64_t P2,
                             int64_t target, int64_t s0, int64_t nb,
                             int64_t* __restrict__ starts,
                             bool* __restrict__ ok) {
  const int64_t end = chase_chain(E, static_cast<int32_t>(P2), s0,
                                  static_cast<int32_t>(nb), starts);
  if (threadIdx.x == 0) *ok = end == target;
}

__global__ void chase_multi_kernel(const int32_t* __restrict__ E, int64_t P2,
                                   const int64_t* __restrict__ targets,
                                   const int64_t* __restrict__ s0s,
                                   int64_t nb, int64_t* __restrict__ starts,
                                   bool* __restrict__ ok) {
  const int64_t b = blockIdx.x;
  const int64_t end = chase_chain(E, static_cast<int32_t>(P2), s0s[b],
                                  static_cast<int32_t>(nb), starts + b * nb);
  if (threadIdx.x == 0) ok[b] = end == targets[b];
}

}  // namespace

JT_API int jt_chase(const void* end_table, int64_t P2, int64_t target,
                    int64_t s0, int64_t nb, void* starts, void* ok,
                    int32_t device, void* stream) {
  cudaSetDevice(device);
  chase_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(end_table), P2, target, s0, nb,
      static_cast<int64_t*>(starts), static_cast<bool*>(ok));
  return static_cast<int>(cudaGetLastError());
}

JT_API int jt_chase_multi(const void* end_table, int64_t P2,
                          const void* targets, const void* s0s, int64_t B,
                          int64_t nb, void* starts, void* ok, int32_t device,
                          void* stream) {
  cudaSetDevice(device);
  chase_multi_kernel<<<static_cast<unsigned>(B), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(end_table), P2,
      static_cast<const int64_t*>(targets), static_cast<const int64_t*>(s0s),
      nb, static_cast<int64_t*>(starts), static_cast<bool*>(ok));
  return static_cast<int>(cudaGetLastError());
}
