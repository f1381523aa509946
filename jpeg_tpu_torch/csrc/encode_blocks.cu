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
// (ops/quantize.py:epilogue_vectors).  The sum runs in full f32 with fused
// multiply-adds in k order (no TF32: pixel blocks reach 255*d*d and the
// JAX kernel asks for Precision.HIGHEST).  The epilogue is an IEEE multiply
// then an IEEE divide (__fmul_rn, __fdiv_rn: never a reciprocal multiply,
// which flips rounds at ties for a divisor such as 3), then rintf, half to
// even as jnp.round and torch.round (roundf would round halves away from
// zero).  The sum's order differs from other implementations, so results
// agree with them up to the +-1-at-provable-ties contract
// (jpeg_tpu_torch/utils/parity.py).
//
// What bounds it on this card: 2*N*L*L flops against 4*N*L bytes in and
// 4*N*L bytes out.  At d = 8 that is 16 flops per byte, at the f32 SIMT
// ridge of an H100 (about 20 flops per byte: 67 TFLOP/s over 3.35 TB/s,
// data-sheet figures), so memory and FMA rate bound it about equally; at
// d = 24 (L = 576) it is 144 flops per byte and the FMA rate bounds it.
//
// What the design does about it: the shared tiled product
// (tiled_product.cuh: 64 blocks x 64 coefficients per thread block, a 4x4
// register tile per thread) reads each pixel block once per 64 output
// columns, and the quantizer epilogue and the int32 cast are fused into the
// store, so the only device-memory traffic is the f32 blocks in, the
// operator (L2-resident) and the int32 levels out.  The TPU's 128-lane
// block packing (kron(I_P, op) operators, pack_factor) was an MXU artifact
// and is gone: the operator is taken unpacked.
#include "tiled_product.cuh"

namespace {

struct PixelLoad {
  const float* __restrict__ x;
  int K;
  __device__ float operator()(int64_t r, int k) const { return x[r * K + k]; }
};

struct LevelStore {
  const float* __restrict__ mul;
  const float* __restrict__ div;
  const float* __restrict__ mask;
  int32_t* __restrict__ out;
  int L;
  __device__ void operator()(int64_t r, int c, float acc) const {
    const float q = __fdiv_rn(__fmul_rn(acc, mul[c]), div[c]);
    out[r * L + c] = static_cast<int32_t>(rintf(q) * mask[c]);
  }
};

__global__ void __launch_bounds__(jt::kTileThreads) encode_blocks_kernel(
    const float* __restrict__ x, const float* __restrict__ opt,
    const float* __restrict__ mul, const float* __restrict__ div,
    const float* __restrict__ mask, int64_t n, int K, int L,
    int32_t* __restrict__ out) {
  jt::tiled_product(PixelLoad{x, K}, opt, n, K, L,
                    LevelStore{mul, div, mask, out, L});
}

}  // namespace

JT_API int jt_encode_blocks(const void* x, const void* op_t, const void* mul,
                            const void* div, const void* mask, int64_t n,
                            int32_t K, int32_t L, void* out, int32_t device,
                            void* stream) {
  cudaSetDevice(device);
  dim3 grid;
  if (!jt::tiled_grid(n, L, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  encode_blocks_kernel<<<grid, jt::kTileThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(op_t),
      static_cast<const float*>(mul), static_cast<const float*>(div),
      static_cast<const float*>(mask), n, K, L, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
