// Shared helpers for the codec's hand-written Hopper kernels.
//
// Every entry point has a plain C interface (loaded with ctypes by
// jpeg_tpu_torch/ops/kernels.py): it selects the device, launches on the
// stream PyTorch passes in, allocates nothing, does not synchronise, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define JT_API extern "C" __attribute__((visibility("default")))

namespace jt {

constexpr int kMaxRun = 15;   // zero-run chain length (0xF0 unit)
constexpr int kMaxSize = 15;  // size-field cap: |amp| <= 2**14 - 1

// Grid for a grid-stride loop over `work` items, capped so the block count
// stays far inside gridDim.x's limit for any input size.
inline unsigned grid_for(int64_t work, int threads) {
  int64_t blocks = (work + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > (int64_t(1) << 20)) blocks = int64_t(1) << 20;
  return static_cast<unsigned>(blocks);
}

// The 32 stream bits that start at bit `bitpos`, MSB first, read through a
// 40-bit window of five bytes.  Bytes outside [0, nbytes) read as zero, so
// a walk that runs off the stream sees EOB headers and never faults.
__device__ __forceinline__ uint32_t peek32(const uint8_t* __restrict__ s,
                                           int64_t nbytes, int64_t bitpos) {
  const int64_t byte = bitpos >> 3;
  uint64_t v = 0;
  for (int j = 0; j < 5; ++j) {
    const int64_t b = byte + j;
    v = (v << 8) | ((b >= 0 && b < nbytes) ? s[b] : 0u);
  }
  return static_cast<uint32_t>(v >> (8 - (bitpos & 7)));
}

}  // namespace jt
