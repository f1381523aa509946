// K4: fused dequantize + dezigzag/IDCT/inflate product + round + clamp.
//
// Replaces the Pallas kernel jpeg_tpu/ops/pallas_kernels.py `_decode_kernel`
// (wrapper `decode_blocks`).
//
// What it computes: out[n, m] = clamp(rint(sum_k f32(lv[n,k] * deq[k]) *
// op_t[k, m]), 0, 255) as uint8, for (N, K) int32 levels, a (K,) int32
// dequantizer and the (K, M) f32 combined decode operator (M = (d*bs)^2, so
// the product also performs the nearest-neighbour inflate).  The dequantize
// product wraps in int32 and converts to f32 round-to-nearest, as
// `(levels * deq).to(torch.float32)` does; it is exact (below 2**24) for the
// qtable and for divisors up to 1024 at |lv| <= 16383.  Round is rintf:
// half to even, as jnp.round and torch.round.  The sum's order differs from
// other implementations, so results agree with them up to the
// +-1-at-provable-ties contract (jpeg_tpu_torch/utils/parity.py).
//
// What bounds it on this card: 2*N*K*M flops against 4*N*K bytes of levels
// in and N*M pixels out.  At the main path's K = 64, M = 256 (a 2048x2048
// image: 1.6 GFLOP, 25 MB) that is 0.0075 ms of device memory (3.35 TB/s)
// against 0.0033 ms at the 495 TFLOP/s TF32 tensor-core rate, so bytes
// bound it; at d = 24 (K = 576, M = 9,216: 15.4 GFLOP, 13 MB) the flops do,
// 0.031 ms.  The f32 SIMT rate (67 TFLOP/s) would bound it at 0.024 ms on
// the main path and 0.23 ms at d = 24; the earlier SIMT tiled product
// reached 26 % of that rate and lost to cuBLAS's f32 product at d = 24.
//
// What the design does about it: the product runs on the TF32 tensor cores
// with f32 accuracy (tc_product.cuh, its 64 x 128 tile: two TF32 pieces of
// each operand, three mma.sync per k8 step, the step's sum reset and added
// in f32 registers; the derived error bound there is B(K) * 2^-23 *
// sum|terms|, B(64) = 20.1 and B(576) = 52.8, inside the contract's
// (K + 16)).  The levels and the operator are staged by cp.async through
// a 3-stage shared-memory ring; the dequantize and the split are fused into
// the fragment loads, round, clamp and uint8 into the epilogue, which
// writes 16 pixels per store.  The TPU's
// 128-lane block packing (kron(I_P, W) operators) and pr-major panels were
// MXU and relayout artifacts and are gone: the operator is taken unpacked.
#include <mutex>

#include "tc_product.cuh"

namespace {

struct DequantA {
  const int32_t* __restrict__ deq;
  int K;
  __device__ float operator()(uint32_t lv, int k) const {
    const uint32_t q = k < K ? static_cast<uint32_t>(__ldg(deq + k)) : 0u;
    return static_cast<float>(static_cast<int32_t>(lv * q));
  }
};

struct PixelEpi {
  using Out = uint8_t;
  static constexpr bool kStaged = false;
  __device__ uint8_t operator()(int64_t, int, float acc) const {
    return static_cast<uint8_t>(fminf(fmaxf(rintf(acc), 0.f), 255.f));
  }
};

// The f32 sums themselves, before the rounding (for measuring the error of
// the split product against an exact reference; not on any codec path).
struct SumEpi {
  using Out = float;
  static constexpr bool kStaged = false;
  __device__ float operator()(int64_t, int, float acc) const { return acc; }
};

using Tile = jt::tc::Wide;

template <bool kVec, class Epi>
__global__ void __launch_bounds__(jt::tc::kThreads, 2)
    decode_blocks_kernel(const int32_t* __restrict__ lv,
                         const int32_t* __restrict__ deq,
                         const float* __restrict__ opt, int64_t n, int K,
                         int M, typename Epi::Out* __restrict__ out,
                         bool vec_store) {
  jt::tc::tc_product<Tile, kVec>(reinterpret_cast<const uint32_t*>(lv), opt,
                                 n, K, M, DequantA{deq, K}, Epi{}, out,
                                 vec_store);
}

// The kernel's opt-in to more than 48 KB of dynamic shared memory, once per
// device and instantiation.
template <bool kVec, class Epi>
cudaError_t opt_in(int device) {
  constexpr int kDevices = 64;
  static std::once_flag once[kDevices];
  static cudaError_t err[kDevices];
  if (device < 0 || device >= kDevices) return cudaErrorInvalidDevice;
  std::call_once(once[device], [device] {
    err[device] = cudaFuncSetAttribute(
        decode_blocks_kernel<kVec, Epi>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::kSmemBytes);
  });
  return err[device];
}

template <class Epi>
int launch(const void* levels, const void* deq, const void* op_t, int64_t n,
           int32_t K, int32_t M, void* out, int32_t device, void* stream) {
  cudaSetDevice(device);
  unsigned blocks;
  if (!jt::tc::tc_grid<Tile>(n, M, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  using Out = typename Epi::Out;
  const bool vec_store = jt::tc::tc_vec_stores<Out>(out, M);
  const bool vec_loads = jt::tc::tc_vec_loads(levels, op_t, K, M);
  const cudaError_t err = vec_loads ? opt_in<true, Epi>(device)
                                    : opt_in<false, Epi>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* kernel = vec_loads ? decode_blocks_kernel<true, Epi>
                           : decode_blocks_kernel<false, Epi>;
  kernel<<<blocks, jt::tc::kThreads, Tile::kSmemBytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(levels), static_cast<const int32_t*>(deq),
      static_cast<const float*>(op_t), n, K, M, static_cast<Out*>(out),
      vec_store);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

JT_API int jt_decode_blocks(const void* levels, const void* deq,
                            const void* op_t, int64_t n, int32_t K,
                            int32_t M, void* out, int32_t device,
                            void* stream) {
  return launch<PixelEpi>(levels, deq, op_t, n, K, M, out, device, stream);
}

// K4's product without its epilogue: out is (N, M) f32.
JT_API int jt_decode_blocks_sums(const void* levels, const void* deq,
                                 const void* op_t, int64_t n, int32_t K,
                                 int32_t M, void* out, int32_t device,
                                 void* stream) {
  return launch<SumEpi>(levels, deq, op_t, n, K, M, out, device, stream);
}
