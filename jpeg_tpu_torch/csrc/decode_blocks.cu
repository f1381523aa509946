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
// What the design does about it: a classic shared-memory tiled product, 64
// blocks x 64 pixels per thread block and a 4x4 register tile per thread,
// with the dequantize fused into the A-tile load and round/clamp/uint8
// fused into the store, so no f32 intermediate reaches device memory and
// the output is 1 byte per pixel.  The TPU's 128-lane block packing
// (kron(I_P, W) operators) and pr-major panels were MXU and relayout
// artifacts and are gone: the operator is taken unpacked.
#include "common.cuh"

namespace {

constexpr int BM = 64;   // blocks per tile
constexpr int BN = 64;   // pixels per tile
constexpr int BK = 16;   // contraction slice
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256

__global__ void __launch_bounds__(THREADS) decode_blocks_kernel(
    const int32_t* __restrict__ lv, const int32_t* __restrict__ deq,
    const float* __restrict__ opt, int64_t n, int K, int M,
    uint8_t* __restrict__ out) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int64_t row0 = int64_t(blockIdx.x) * BM;
  const int col0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK;
      const int64_t gr = row0 + r;
      const int gk = k0 + kk;
      float v = 0.f;
      if (gr < n && gk < K) v = static_cast<float>(lv[gr * K + gk] * deq[gk]);
      As[kk][r] = v;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = e / BN, c = e % BN;
      const int gk = k0 + kk, gc = col0 + c;
      Bs[kk][c] = (gk < K && gc < M) ? opt[int64_t(gk) * M + gc] : 0.f;
    }
    __syncthreads();
    const int kend = K - k0 < BK ? K - k0 : BK;
    for (int kk = 0; kk < kend; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gr = row0 + ty * TM + i;
    if (gr >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx * TN + j;
      if (gc < M) {
        const float p = fminf(fmaxf(rintf(acc[i][j]), 0.f), 255.f);
        out[gr * M + gc] = static_cast<uint8_t>(p);
      }
    }
  }
}

}  // namespace

JT_API int jt_decode_blocks(const void* levels, const void* deq,
                            const void* op_t, int64_t n, int32_t K,
                            int32_t M, void* out, int32_t device,
                            void* stream) {
  cudaSetDevice(device);
  const int64_t row_tiles = (n + BM - 1) / BM;
  if (row_tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(row_tiles), (M + BN - 1) / BN);
  decode_blocks_kernel<<<grid, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(levels), static_cast<const int32_t*>(deq),
      static_cast<const float*>(op_t), n, K, M, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
