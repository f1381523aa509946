// The tiled SIMT f32 product of K5 (encode_blocks.cu), its only user since
// K4 moved to the tensor-core product (tc_product.cuh), which K5 is to move
// onto next: out[n, m] = epilogue(n, m, sum_k a(n, k) * op_t[k, m]) for an
// (N, K) left operand read through a load functor and a (K, M) f32
// operator.
//
// A classic shared-memory tiled product: 64 rows x 64 columns per thread
// block, a 16-deep contraction slice, and a 4x4 register tile per thread.
// The sum runs in full f32 with fused multiply-adds in k order, from 0;
// there is no TF32 or other reduced precision.  The caller's load functor
// fuses its input conversion into the A-tile load, and its store functor
// fuses the epilogue into the store, so no f32 intermediate reaches device
// memory.
#pragma once

#include "common.cuh"

namespace jt {

constexpr int kTileM = 64;   // rows (blocks) per tile
constexpr int kTileN = 64;   // output columns per tile
constexpr int kTileK = 16;   // contraction slice
constexpr int kRegM = 4;
constexpr int kRegN = 4;
constexpr int kTileThreads = (kTileM / kRegM) * (kTileN / kRegN);   // 256

// One thread block's tile of the product; blockIdx.x walks the rows,
// blockIdx.y the columns.  load_a(row, k) -> float is called only in
// range; store(row, col, acc) only in range.
template <class LoadA, class Store>
__device__ __forceinline__ void tiled_product(LoadA load_a,
                                              const float* __restrict__ opt,
                                              int64_t n, int K, int M,
                                              Store store) {
  __shared__ float As[kTileK][kTileM];
  __shared__ float Bs[kTileK][kTileN];
  const int tid = threadIdx.x;
  const int tx = tid % (kTileN / kRegN);
  const int ty = tid / (kTileN / kRegN);
  const int64_t row0 = int64_t(blockIdx.x) * kTileM;
  const int col0 = blockIdx.y * kTileN;

  float acc[kRegM][kRegN];
#pragma unroll
  for (int i = 0; i < kRegM; ++i)
#pragma unroll
    for (int j = 0; j < kRegN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kTileK) {
    for (int e = tid; e < kTileM * kTileK; e += kTileThreads) {
      const int r = e / kTileK, kk = e % kTileK;
      const int64_t gr = row0 + r;
      const int gk = k0 + kk;
      As[kk][r] = (gr < n && gk < K) ? load_a(gr, gk) : 0.f;
    }
    for (int e = tid; e < kTileK * kTileN; e += kTileThreads) {
      const int kk = e / kTileN, c = e % kTileN;
      const int gk = k0 + kk, gc = col0 + c;
      Bs[kk][c] = (gk < K && gc < M) ? opt[int64_t(gk) * M + gc] : 0.f;
    }
    __syncthreads();
    const int kend = K - k0 < kTileK ? K - k0 : kTileK;
    for (int kk = 0; kk < kend; ++kk) {
      float a[kRegM], b[kRegN];
#pragma unroll
      for (int i = 0; i < kRegM; ++i) a[i] = As[kk][ty * kRegM + i];
#pragma unroll
      for (int j = 0; j < kRegN; ++j) b[j] = Bs[kk][tx * kRegN + j];
#pragma unroll
      for (int i = 0; i < kRegM; ++i)
#pragma unroll
        for (int j = 0; j < kRegN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRegM; ++i) {
    const int64_t gr = row0 + ty * kRegM + i;
    if (gr >= n) continue;
#pragma unroll
    for (int j = 0; j < kRegN; ++j) {
      const int gc = col0 + tx * kRegN + j;
      if (gc < M) store(gr, gc, acc[i][j]);
    }
  }
}

// The launch grid of tiled_product, or false where the row tiles overflow
// gridDim.x.
inline bool tiled_grid(int64_t n, int M, dim3* grid) {
  const int64_t row_tiles = (n + kTileM - 1) / kTileM;
  if (row_tiles > 0x7fffffff) return false;
  *grid = dim3(static_cast<unsigned>(row_tiles), (M + kTileN - 1) / kTileN);
  return true;
}

}  // namespace jt
