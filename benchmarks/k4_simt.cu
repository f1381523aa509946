// The register-blocked SIMT design of K4 (decode_blocks), kept for
// benchmarks/torch_k4_designs.py, which times it against the package's
// tensor-core K4 (jpeg_tpu_torch/csrc/decode_blocks.cu).  It is not part of
// the package and no codec path calls it.
//
// out[n, m] = clamp(rint(sum_k f32(lv[n,k] * deq[k]) * op_t[k, m]), 0, 255)
// in full f32 FMAs in k order.  128 x 128 outputs per thread block of 256
// threads, 8 x 8 a thread (rows ty*4 + {0..3} and 64 + ty*4 + {0..3},
// columns likewise, so that neighbouring threads read neighbouring float4s
// of shared memory); slices of 16 of K through a 3-stage cp.async ring; A
// dequantized and transposed once per slice into a double buffer, one slice
// ahead of the products (one barrier a slice); packed 4-pixel stores.
// Takes K and M multiples of 4 and 16-byte aligned operands only.
#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 16, kStages = 3, kThreads = 256;
constexpr int kAStride = kBK + 4;          // raw A rows (words)
constexpr int kStageWords = kBM * kAStride + kBK * kBN;
constexpr int kATStride = kBM + 4;         // transposed A rows (floats)
constexpr int kSmemBytes =
    kStages * kStageWords * 4 + 2 * kBK * kATStride * 4;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0));
}

__global__ void __launch_bounds__(kThreads, 2)
    simt_kernel(const int32_t* __restrict__ lv,
                const int32_t* __restrict__ deq,
                const float* __restrict__ op_t, int64_t n, int K, int M,
                uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem);
  float* at = reinterpret_cast<float*>(smem + kStages * kStageWords * 4);
  const uint32_t* a = reinterpret_cast<const uint32_t*>(lv);
  const int col_tiles = (M + kBN - 1) / kBN;
  const int64_t row0 = (int64_t(blockIdx.x) / col_tiles) * kBM;
  const int col0 = static_cast<int>(blockIdx.x % col_tiles) * kBN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  auto load = [&](int kt) {
    uint32_t* As = ring + (kt % kStages) * kStageWords;
    float* Bs = reinterpret_cast<float*>(As + kBM * kAStride);
    const int k0 = kt * kBK;
#pragma unroll
    for (int c = tid; c < kBM * kBK / 4; c += kThreads) {
      const int r = c / (kBK / 4), kc = (c % (kBK / 4)) * 4;
      const bool ok = row0 + r < n && k0 + kc < K;
      cp_async16(As + r * kAStride + kc, ok ? a + (row0 + r) * K + k0 + kc : a,
                 ok);
    }
#pragma unroll
    for (int c = tid; c < kBK * kBN / 4; c += kThreads) {
      const int kk = c / (kBN / 4), nc = (c % (kBN / 4)) * 4;
      const bool ok = k0 + kk < K && col0 + nc < M;
      cp_async16(Bs + kk * kBN + nc,
                 ok ? op_t + int64_t(k0 + kk) * M + col0 + nc : op_t, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  auto transpose = [&](int kt) {   // raw A slice -> dequantized, transposed
    const uint32_t* As = ring + (kt % kStages) * kStageWords;
    float* dst = at + (kt & 1) * kBK * kATStride;
#pragma unroll
    for (int e = tid; e < kBM * kBK / 4; e += kThreads) {
      const int m = e % kBM, j = (e / kBM) * 4;
      const uint4 v = *reinterpret_cast<const uint4*>(As + m * kAStride + j);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = kt * kBK + j + q;
        const uint32_t d = k < K ? static_cast<uint32_t>(__ldg(deq + k)) : 0u;
        dst[(j + q) * kATStride + m] =
            static_cast<float>(static_cast<int32_t>(w[q] * d));
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int ktiles = (K + kBK - 1) / kBK;
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load(s);
    else asm volatile("cp.async.commit_group;\n" ::);
  }
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
  __syncthreads();
  transpose(0);
  for (int kt = 0; kt < ktiles; ++kt) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (kt + kStages - 1 < ktiles) load(kt + kStages - 1);
    else asm volatile("cp.async.commit_group;\n" ::);
    if (kt + 1 < ktiles) transpose(kt + 1);
    const float* Bs = reinterpret_cast<const float*>(
        ring + (kt % kStages) * kStageWords + kBM * kAStride);
    const float* A = at + (kt & 1) * kBK * kATStride;
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(A + k * kATStride + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(A + k * kATStride + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * kBN + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(Bs + k * kBN + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + h * 64 + tx * 4;
      if (c >= M) continue;
      uint32_t word = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        word |= static_cast<uint32_t>(
                    fminf(fmaxf(rintf(acc[i][h * 4 + q]), 0.f), 255.f))
                << (8 * q);
      *reinterpret_cast<uint32_t*>(out + r * M + c) = word;
    }
  }
}

}  // namespace

extern "C" int k4_simt(const void* levels, const void* deq, const void* op_t,
                       int64_t n, int K, int M, void* out, void* stream) {
  static std::once_flag once;
  static cudaError_t err;
  std::call_once(once, [] {
    err = cudaFuncSetAttribute(simt_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
  });
  if (err != cudaSuccess) return err;
  if (K % 4 || M % 4) return cudaErrorInvalidValue;
  const int64_t tiles = ((n + kBM - 1) / kBM) * ((M + kBN - 1) / kBN);
  simt_kernel<<<static_cast<unsigned>(tiles), kThreads, kSmemBytes,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(levels), static_cast<const int32_t*>(deq),
      static_cast<const float*>(op_t), n, K, M, static_cast<uint8_t*>(out));
  return cudaGetLastError();
}
