// K4: fused dequantize + dezigzag/IDCT/inflate product + round + clamp.
//
// Replaces the Pallas kernel jpeg_tpu/ops/pallas_kernels.py `_decode_kernel`
// (wrapper `decode_blocks`).
//
// What it computes: out[n, m] = clamp(rint(sum_k f32(lv[n,k] * deq[k]) *
// op_t[k, m]), 0, 255) as uint8, for (N, K) int32 levels, a (K,) int32
// dequantizer and the (K, M) f32 combined decode operator (M = (d*bs)^2, so
// the product also performs the nearest-neighbour inflate).  The
// dequantize product is exact in int32 and in f32 (|lv| <= 16383 and the
// largest multiplier keeps it below 2**24 for the qtable).  Round is
// rintf: half to even, as jnp.round and torch.round; roundf would round
// halves away from zero.  The sum runs in full f32 with fused
// multiply-adds in k order; there is no TF32 or other reduced precision.
// Its order differs from other implementations, so results agree with them
// only up to the +-1-at-provable-ties contract (jpeg_tpu_torch/utils/
// parity.py).
//
// What bounds it on this card: 2*N*K*M flops (1.6 GFLOP for a 4 MP image,
// K = 64, M = 256) against 4*N*K bytes in and N*M bytes out, 64 flops per
// byte.  The f32 SIMT ridge of an H100 is about 20 flops per byte (67
// TFLOP/s over 3.35 TB/s, data-sheet figures), so the FMA rate bounds it.
//
// What the design does about it: the shared tiled product
// (tiled_product.cuh: 64 blocks x 64 pixels per thread block, a 4x4
// register tile per thread), with the dequantize fused into the A-tile load
// and round/clamp/uint8 fused into the store, so no f32 intermediate
// reaches device memory and the output is 1 byte per pixel.  The TPU's
// 128-lane block packing (kron(I_P, W) operators) and pr-major panels were
// MXU and relayout artifacts and are gone: the operator is taken unpacked.
#include "tiled_product.cuh"

namespace {

struct DequantLoad {
  const int32_t* __restrict__ lv;
  const int32_t* __restrict__ deq;
  int K;
  __device__ float operator()(int64_t r, int k) const {
    return static_cast<float>(lv[r * K + k] * deq[k]);
  }
};

struct PixelStore {
  uint8_t* __restrict__ out;
  int M;
  __device__ void operator()(int64_t r, int c, float acc) const {
    const float p = fminf(fmaxf(rintf(acc), 0.f), 255.f);
    out[r * M + c] = static_cast<uint8_t>(p);
  }
};

__global__ void __launch_bounds__(jt::kTileThreads) decode_blocks_kernel(
    const int32_t* __restrict__ lv, const int32_t* __restrict__ deq,
    const float* __restrict__ opt, int64_t n, int K, int M,
    uint8_t* __restrict__ out) {
  jt::tiled_product(DequantLoad{lv, deq, K}, opt, n, K, M, PixelStore{out, M});
}

}  // namespace

JT_API int jt_decode_blocks(const void* levels, const void* deq,
                            const void* op_t, int64_t n, int32_t K,
                            int32_t M, void* out, int32_t device,
                            void* stream) {
  cudaSetDevice(device);
  dim3 grid;
  if (!jt::tiled_grid(n, M, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  decode_blocks_kernel<<<grid, jt::kTileThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(levels), static_cast<const int32_t*>(deq),
      static_cast<const float*>(op_t), n, K, M, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
