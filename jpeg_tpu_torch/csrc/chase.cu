// K7 and K8: the orbit chase of the boundary scan, end table -> starts.
//
// Replace the Pallas kernels jpeg_tpu/ops/pallas_kernels.py `_chase_kernel`
// (wrapper `chase_starts`; K7, one chain) and `_chase_multi_kernel`
// (wrapper `chase_starts_multi`; K8, one chain per band of a container).
// Both run the same launches; K7 is K8 at B = 1.
//
// What they compute: given K6's end table E (P2 = P + 2 entries, ERR =
// P + 1 absorbing), a chain from s0 records starts[0] = s0 and
// starts[b + 1] = E[starts[b]] for nb starts; ok = (E[starts[nb - 1]] ==
// target), the chain's end offset; nb = 0 gives ok = (s0 == target).
// Positions are clamped to [0, P2 - 1] before they index E, so ERR
// absorbs; E's entries must lie in that range, as K6's do.  Starts are
// int64 (what K3 takes).
//
// What bounds them on this card: the chain is serial.  Followed one step
// at a time it is nb dependent loads per band, each at least a
// shared-memory latency (about 60 cycles with the loop around it), and
// only B blocks can work on it.
//
// What the design does about it: the wrapper (ops/kernels.py `chase_plan`)
// picks one of two forms from nb, on the caller's stream, with scratch it
// allocates.
//  * Short chains (nb <= `CHASE_DIRECT_MAX`): one launch.  One block per
//    band follows E itself, thread 0 through shared-memory windows that the
//    block's other warps stage ahead of it, and writes every start and the
//    check.  Nothing else runs, so a short chain pays one launch, and its
//    windows are small (E moves about 28 entries a step), so the block
//    needs neither long staging before its first step nor more shared
//    memory than a kernel gets by default.
//  * Long chains: three launches, with k = kJump.
//    1. Jump table J = f^k over all P2 entries, f(x) = clamp(E[x]): one
//       thread per entry follows E k times.  E moves forward by one block a
//       step (about 28 bytes on the main path), and neighbouring chains
//       merge within a few blocks, so a warp's loads stay within a few
//       cache lines and hit L1 or L2.  ERR stays absorbing in J.
//    2. Anchor chase: the same chain kernel follows J for ceil(nb / k) - 1
//       steps and records every k-th start.  One of J's jumps spans about
//       k blocks (some 450 entries at k = 16), so its windows are 4x the
//       short form's and hold dozens of steps; a jump past the staged
//       window restages where the chain went.
//    3. Fill: one thread per anchor follows E up to k times and writes the
//       starts up to the next anchor; the thread of a band's last anchor
//       takes the step past the last start and sets ok.
// What bounds the long form now: phase 2, which stages the band's whole
// span of J (4 bytes per stream byte) through one SM while it takes
// ceil(nb / k) - 1 serial shared-memory steps; then phase 1's P2 x k
// dependent cached loads.  A larger k shortens the serial chain but not
// the span, and lengthens phases 1 and 3.  The TPU forms (the whole table
// resident in VMEM behind a size gate, the 128-lane packed start rows, the
// one-hot lane reduce per step) are gone.
#include <mutex>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kJump = 16;          // ops/kernels.py CHASE_JUMP
constexpr int kTableThreads = 256;
constexpr int kFillThreads = 128;
// The chain kernel's threads and window (int32 entries; two are staged),
// short form / long form: 2 x 16 KB and 2 x 64 KB of shared memory.
template <bool kDirect>
constexpr int kChainThreads = kDirect ? 512 : 1024;
template <bool kDirect>
constexpr int kWindow = kDirect ? 1 << 12 : 1 << 14;
template <bool kDirect>
constexpr int kChainSmem = 2 * kWindow<kDirect> * sizeof(int32_t);

__device__ __forceinline__ int32_t clamp_to(int64_t v, int32_t hi) {
  return static_cast<int32_t>(v < 0 ? 0 : (v > hi ? hi : v));
}

// Phase 1: J[q] = f^k(q).
__global__ void jump_table_kernel(const int32_t* __restrict__ E, int32_t P2,
                                  int32_t* __restrict__ J) {
  for (int64_t q = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; q < P2;
       q += int64_t(gridDim.x) * blockDim.x) {
    int32_t pos = static_cast<int32_t>(q);
#pragma unroll
    for (int i = 0; i < kJump; ++i) pos = clamp_to(__ldg(E + pos), P2 - 1);
    J[q] = pos;
  }
}

// Threads [first, blockDim.x) copy T[base, base + kWin) (clipped to P2)
// into `win`.  `base` is a multiple of 4, so a whole window goes as
// 16-byte loads when T is 16-byte aligned.
template <int kWin>
__device__ __forceinline__ void stage(int32_t* __restrict__ win,
                                      const int32_t* __restrict__ T,
                                      int32_t P2, int64_t base, int first) {
  const int stride = blockDim.x - first;
  const int t0 = threadIdx.x - first;
  if (base + kWin <= P2 && (reinterpret_cast<uintptr_t>(T) & 15) == 0) {
    const int4* __restrict__ src = reinterpret_cast<const int4*>(T + base);
    int4* dst = reinterpret_cast<int4*>(win);
#pragma unroll 4
    for (int t = t0; t < kWin / 4; t += stride) dst[t] = src[t];
  } else {
    for (int t = t0; t < kWin; t += stride) {
      if (base + t < P2) win[t] = T[base + t];
    }
  }
}

// One block per band follows T from clamp(s0_b) and records
// chain[b * A + j] = T^j(clamp(s0_b)) for 1 <= j < A.  Phase 2 of the long
// form (T = J, chain = the int32 anchors; phase 3 takes anchor 0 from s0),
// or with kDirect the whole short form (T = E, A = nb, chain = the int64
// starts with starts[0] = s0 as given, and ok from the step past the last
// start).
template <bool kDirect>
__global__ void __launch_bounds__(kChainThreads<kDirect>)
chain_kernel(const int32_t* __restrict__ T, int32_t P2,
             const int64_t* __restrict__ s0s, int64_t s0, int32_t A,
             std::conditional_t<kDirect, int64_t, int32_t>* __restrict__ chain,
             const int64_t* __restrict__ targets, int64_t target,
             bool* __restrict__ ok) {
  constexpr int kWin = kWindow<kDirect>;
  extern __shared__ int4 smem[];
  int32_t* const win = reinterpret_cast<int32_t*>(smem);
  // Thread 0 publishes its state here; two slots, by round parity, so it
  // never overwrites a slot that another thread has still to read.
  __shared__ int32_t sh_pos[2], sh_done[2];
  const int64_t b = blockIdx.x;
  auto* __restrict__ out = chain + b * A;
  const int64_t s0b = s0s ? s0s[b] : s0;
  if constexpr (kDirect) {
    if (threadIdx.x == 0) {
      if (A == 0) ok[b] = s0b == (targets ? targets[b] : target);
      else out[0] = s0b;
    }
    if (A == 0) return;
  }
  int32_t pos = clamp_to(s0b, P2 - 1);
  int32_t done = 1;
  int64_t base = pos & ~3;
  int cur = 0;
  stage<kWin>(win, T, P2, base, 0);
  __syncthreads();
  for (int round = 0;; ++round) {
    const int64_t next = base + kWin;
    if (threadIdx.x == 0) {
      const int32_t* __restrict__ w = win + cur * kWin;
      uint32_t c = static_cast<uint32_t>(pos - base);
      while (done < A && c < kWin) {      // until it leaves the window
        pos = w[c];
        out[done++] = pos;
        c = static_cast<uint32_t>(pos - base);
      }
      if (kDirect && done >= A) {         // the step past the last start
        ok[b] = clamp_to(__ldg(T + pos), P2 - 1) ==
                (targets ? targets[b] : target);
      }
      sh_pos[round & 1] = pos;
      sh_done[round & 1] = done;
    } else if (threadIdx.x >= 32) {
      stage<kWin>(win + (cur ^ 1) * kWin, T, P2, next, 32);
    }
    __syncthreads();
    pos = sh_pos[round & 1];
    done = sh_done[round & 1];
    if (done >= A) return;
    if (static_cast<uint64_t>(pos - next) < kWin) {     // in the staged one
      base = next;
      cur ^= 1;
    } else {                                            // elsewhere: restage
      base = pos & ~3;
      stage<kWin>(win + cur * kWin, T, P2, base, 0);
      __syncthreads();
    }
  }
}

// Phase 3: thread (b, j) writes starts [j k, min((j + 1) k, nb)) of band b
// from anchor j; the last anchor's thread sets ok[b].
__global__ void fill_kernel(const int32_t* __restrict__ E, int32_t P2,
                            const int64_t* __restrict__ targets,
                            int64_t target, const int64_t* __restrict__ s0s,
                            int64_t s0, int64_t B, int64_t nb, int32_t A,
                            const int32_t* __restrict__ anchors,
                            int64_t* __restrict__ starts,
                            bool* __restrict__ ok) {
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < B * A;
       i += int64_t(gridDim.x) * blockDim.x) {
    const int64_t b = i / A;
    const int32_t j = static_cast<int32_t>(i - b * A);
    const int64_t s0b = s0s ? s0s[b] : s0;
    int32_t pos = j == 0 ? clamp_to(s0b, P2 - 1) : anchors[i];
    const int64_t first = int64_t(j) * kJump;
    const int64_t cnt = nb - first < kJump ? nb - first : kJump;
    int64_t* __restrict__ out = starts + b * nb + first;
    for (int64_t t = 0; t < cnt; ++t) {
      out[t] = (t == 0 && j == 0) ? s0b : pos;
      pos = clamp_to(__ldg(E + pos), P2 - 1);
    }
    if (first + cnt == nb) ok[b] = pos == (targets ? targets[b] : target);
  }
}

// The long form's two windows need more dynamic shared memory than a
// kernel gets by default; the kernel opts in once per device.
cudaError_t opt_in(int device) {
  constexpr int kDevices = 64;
  static std::once_flag once[kDevices];
  static cudaError_t err[kDevices];
  if (device < 0 || device >= kDevices) return cudaErrorInvalidDevice;
  std::call_once(once[device], [device] {
    err[device] = cudaFuncSetAttribute(
        chain_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kChainSmem<false>);
  });
  return err[device];
}

// `jump` and `anchors` are the long form's scratch (P2 and B * ceil(nb /
// kJump) int32 entries); null selects the short form, as does nb <= kJump.
int launch_chase(const void* end_table, int64_t P2, const void* targets,
                 int64_t target, const void* s0s, int64_t s0, int64_t B,
                 int64_t nb, void* jump, void* anchors, void* starts,
                 void* ok, int32_t device, cudaStream_t stream) {
  const int32_t* E = static_cast<const int32_t*>(end_table);
  const int32_t p2 = static_cast<int32_t>(P2);
  const int64_t* tg = static_cast<const int64_t*>(targets);
  const int64_t* s0_ptr = static_cast<const int64_t*>(s0s);
  int64_t* starts_ptr = static_cast<int64_t*>(starts);
  bool* ok_ptr = static_cast<bool*>(ok);
  if (jump == nullptr || nb <= kJump) {
    chain_kernel<true><<<static_cast<unsigned>(B), kChainThreads<true>,
                         kChainSmem<true>, stream>>>(
        E, p2, s0_ptr, s0, static_cast<int32_t>(nb), starts_ptr, tg, target,
        ok_ptr);
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t err = opt_in(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int32_t A = static_cast<int32_t>((nb + kJump - 1) / kJump);
  int32_t* J = static_cast<int32_t*>(jump);
  int32_t* anchor_ptr = static_cast<int32_t*>(anchors);
  jump_table_kernel<<<jt::grid_for(P2, kTableThreads), kTableThreads, 0,
                      stream>>>(E, p2, J);
  chain_kernel<false><<<static_cast<unsigned>(B), kChainThreads<false>,
                        kChainSmem<false>, stream>>>(
      J, p2, s0_ptr, s0, A, anchor_ptr, nullptr, 0, nullptr);
  fill_kernel<<<jt::grid_for(B * A, kFillThreads), kFillThreads, 0,
                stream>>>(E, p2, tg, target, s0_ptr, s0, B, nb, A,
                          anchor_ptr, starts_ptr, ok_ptr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

JT_API int jt_chase(const void* end_table, int64_t P2, int64_t target,
                    int64_t s0, int64_t nb, void* jump, void* anchors,
                    void* starts, void* ok, int32_t device, void* stream) {
  cudaSetDevice(device);
  return launch_chase(end_table, P2, nullptr, target, nullptr, s0, 1, nb,
                      jump, anchors, starts, ok, device,
                      static_cast<cudaStream_t>(stream));
}

JT_API int jt_chase_multi(const void* end_table, int64_t P2,
                          const void* targets, const void* s0s, int64_t B,
                          int64_t nb, void* jump, void* anchors, void* starts,
                          void* ok, int32_t device, void* stream) {
  cudaSetDevice(device);
  return launch_chase(end_table, P2, targets, 0, s0s, 0, B, nb, jump,
                      anchors, starts, ok, device,
                      static_cast<cudaStream_t>(stream));
}
