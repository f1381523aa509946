// K5: fused transform+zigzag product + quantizer epilogue.
//
// Replaces the Pallas kernel jpeg_tpu/ops/pallas_kernels.py `_encode_kernel`
// (wrapper `encode_blocks`).  Its caller is the f32 encode of the DFT on
// ragged geometry (ops/band.py, the `blocks` branch): pixel blocks after
// subsample and edge padding, times the real-DFT operator.
//
// What it computes: out[n, l] = int32(rint(sum_k x[n,k] * op_t[k,l] *
// mul[l] / div[l]) * mask[l]) for (N, K) f32 pixel blocks, the (K, L) f32
// operator (K = L = d*d) and three (L,) f32 quantizer vectors
// (ops/quantize.py:epilogue_vectors).  The sum has f32 accuracy: the JAX
// kernel asks for Precision.HIGHEST, and pixel blocks reach 255*d*d; TF32
// enters only as the exact pieces of tc_product.cuh's split.  The epilogue
// is an IEEE multiply then an IEEE divide (__fmul_rn, __fdiv_rn: never a
// reciprocal multiply, which flips rounds at ties for a divisor such as 3),
// then rintf, half to even as jnp.round and torch.round (roundf would round
// halves away from zero).  The sum's order differs from other
// implementations, so results agree with them up to the
// +-1-at-provable-ties contract (jpeg_tpu_torch/utils/parity.py).
//
// What bounds it on this card: 2*N*K*L flops against 4*N*K bytes in and
// 4*N*L bytes out.  At d = 8 and N = 196,608 (BASELINE (4b), 2048x2048:
// 1.6 GFLOP, 101 MB) that is 0.030 ms of device memory (3.35 TB/s) against
// 0.003 ms at the 495 TFLOP/s TF32 tensor-core rate, so bytes bound it; at
// d = 24 (L = 576) it is 144 flops a byte, at the TF32 ridge (148).  The
// f32 SIMT rate (67 TFLOP/s) alone would take 0.024 ms at d = 8: the
// earlier SIMT tiled product reached a quarter of the byte bound and lost
// to cuBLAS's full-f32 product of the same operands.
//
// What the design does about it: the product is K4's 3xTF32 tensor-core
// product (tc_product.cuh: two TF32 pieces of each operand, three mma.sync a
// k8 step, each step's sum added in f32 registers; error at most
// B(K) * 2^-23 * sum|terms|, B(64) = 20.1, B(576) = 52.8, inside the
// contract's K + 16).  The pixel words are read as they are (a bit cast, 0
// on the zero-filled edge), staged with the operator by cp.async through the
// 3-stage ring; the raw sums are staged in shared memory and the quantizer
// epilogue and the int32 cast run as the rows leave (LevelEpi::kStaged:
// converting in registers before the staging was slower, see
// tc_product.cuh), so the only device-memory traffic is the f32 blocks in,
// the operator (L2-resident) and the int32 levels out.  At L <= 64 the tile
// is 128 blocks x 64 coefficients (a 64 x 128 tile would be half
// zero-filled: half its mma.sync, splits, operator staging and epilogue
// wasted), above 64 coefficients it is K4's 64 x 128.  The TPU's 128-lane
// block packing (kron(I_P, op) operators, pack_factor) was an MXU artifact
// and is gone: the operator is taken unpacked.
#include <mutex>

#include "tc_product.cuh"

namespace {

struct PixelA {
  __device__ float operator()(uint32_t word, int) const {
    return __uint_as_float(word);
  }
};

struct LevelEpi {
  using Out = int32_t;
  static constexpr bool kStaged = true;
  const float* __restrict__ mul;
  const float* __restrict__ div;
  const float* __restrict__ mask;
  __device__ int32_t operator()(int64_t, int c, float acc) const {
    const float q = __fdiv_rn(__fmul_rn(acc, __ldg(mul + c)), __ldg(div + c));
    return static_cast<int32_t>(rintf(q) * __ldg(mask + c));
  }
};

// The f32 sums themselves, before the epilogue (for measuring the error of
// the split product against an exact reference; not on any codec path).
struct SumEpi {
  using Out = float;
  static constexpr bool kStaged = false;
  __device__ float operator()(int64_t, int, float acc) const { return acc; }
};

template <class S, bool kVec, class Epi>
__global__ void __launch_bounds__(jt::tc::kThreads, 2)
    encode_blocks_kernel(const float* __restrict__ x,
                         const float* __restrict__ opt, int64_t n, int K,
                         int L, Epi epi, typename Epi::Out* __restrict__ out,
                         bool vec_store) {
  jt::tc::tc_product<S, kVec>(reinterpret_cast<const uint32_t*>(x), opt, n,
                              K, L, PixelA{}, epi, out, vec_store);
}

// The kernel's opt-in to more than 48 KB of dynamic shared memory, once per
// device and instantiation.
template <class S, bool kVec, class Epi>
cudaError_t opt_in(int device) {
  constexpr int kDevices = 64;
  static std::once_flag once[kDevices];
  static cudaError_t err[kDevices];
  if (device < 0 || device >= kDevices) return cudaErrorInvalidDevice;
  std::call_once(once[device], [device] {
    err[device] = cudaFuncSetAttribute(
        encode_blocks_kernel<S, kVec, Epi>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
  });
  return err[device];
}

template <class S, class Epi>
int launch_shape(const void* x, const void* op_t, int64_t n, int32_t K,
                 int32_t L, Epi epi, void* out, int32_t device,
                 void* stream) {
  unsigned blocks;
  if (!jt::tc::tc_grid<S>(n, L, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  using Out = typename Epi::Out;
  const bool vec_store = jt::tc::tc_vec_stores<Out>(out, L);
  const bool vec_loads = jt::tc::tc_vec_loads(x, op_t, K, L);
  const cudaError_t err = vec_loads ? opt_in<S, true, Epi>(device)
                                    : opt_in<S, false, Epi>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* kernel = vec_loads ? encode_blocks_kernel<S, true, Epi>
                           : encode_blocks_kernel<S, false, Epi>;
  kernel<<<blocks, jt::tc::kThreads, S::kSmemBytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(op_t), n, K, L,
      epi, static_cast<Out*>(out), vec_store);
  return static_cast<int>(cudaGetLastError());
}

// The tile by the output width: 128 x 64 up to 64 coefficients, else
// 64 x 128.
template <class Epi>
int launch(const void* x, const void* op_t, int64_t n, int32_t K, int32_t L,
           Epi epi, void* out, int32_t device, void* stream) {
  cudaSetDevice(device);
  return L <= jt::tc::Tall::kBN
             ? launch_shape<jt::tc::Tall>(x, op_t, n, K, L, epi, out, device,
                                          stream)
             : launch_shape<jt::tc::Wide>(x, op_t, n, K, L, epi, out, device,
                                          stream);
}

}  // namespace

JT_API int jt_encode_blocks(const void* x, const void* op_t, const void* mul,
                            const void* div, const void* mask, int64_t n,
                            int32_t K, int32_t L, void* out, int32_t device,
                            void* stream) {
  const LevelEpi epi{static_cast<const float*>(mul),
                     static_cast<const float*>(div),
                     static_cast<const float*>(mask)};
  return launch(x, op_t, n, K, L, epi, out, device, stream);
}

// K5's product without its epilogue: out is (N, L) f32.
JT_API int jt_encode_blocks_sums(const void* x, const void* op_t, int64_t n,
                                 int32_t K, int32_t L, void* out,
                                 int32_t device, void* stream) {
  return launch(x, op_t, n, K, L, SumEpi{}, out, device, stream);
}
