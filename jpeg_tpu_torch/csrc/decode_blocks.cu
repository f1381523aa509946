// K4: fused dequantize + dezigzag/IDCT product + round + clamp + inflate.
//
// Replaces the Pallas kernel jpeg_tpu/ops/pallas_kernels.py `_decode_kernel`
// (wrapper `decode_blocks`).
//
// What it computes: for (N, K) int32 levels, a (K,) int32 dequantizer and
// the (K, M) f32 decode operator, the pixels p[n, m] = clamp(rint(sum_k
// f32(lv[n,k] * deq[k]) * op_t[k, m]), 0, 255) as uint8, each written to
// its bs x bs places: with M = d*d, pixel (i, j) of block n fills rows
// i*bs .. i*bs+bs-1 and columns j*bs .. j*bs+bs-1 of the block's (d*bs) x
// (d*bs) pixels, out[n] (the nearest-neighbour inflate; bs = 1 writes the
// (N, M) product itself, for any M).  The dequantize product wraps in
// int32 and converts to f32 round-to-nearest, as `(levels *
// deq).to(torch.float32)` does; it is exact (below 2**24) for the qtable
// and for divisors up to 1024 at |lv| <= 16383.  Round is rintf: half to
// even, as jnp.round and torch.round.  The sum's order differs from other
// implementations, so results agree with them up to the
// +-1-at-provable-ties contract (jpeg_tpu_torch/utils/parity.py).  The
// TPU kernel took the (K, (d*bs)^2) combined operator, whose columns are
// the d*d distinct ones each repeated bs*bs times, and computed every
// replica; this kernel computes each pixel once, and the store repeats it.
// A pixel's sum does not depend on the tile it lies in, so every pixel is
// bit-equal to the same kernel's product with the combined operator at
// bs = 1.
//
// What bounds it on this card: 2*N*K*M flops against 4*N*K bytes of levels
// in and N*M*bs*bs pixels out.  A 4K frame at d = 8, bs 4 (N = 24,480, K =
// M = 64: 0.2 GFLOP, 6.3 MB in and 25.1 MB out) is bytes, 0.0094 ms of
// device memory (3.35 TB/s); at d = 24, bs 4 (N = 2,760, K = M = 576:
// 1.83 GFLOP, 6.4 MB in, 25.4 MB out) the bytes take 0.0095 ms and the
// flops 0.0037 ms at the 495 TFLOP/s TF32 tensor-core rate (the product
// runs three TF32 MMAs a step, 0.011 ms at that rate).
//
// What the design does about it: the product runs on the TF32 tensor cores
// with f32 accuracy (tc_product.cuh: two TF32 pieces of each operand,
// three mma.sync per k8 step, the step's sum reset and added in f32
// registers; the derived error bound there is B(K) * 2^-23 * sum|terms|,
// B(64) = 20.1 and B(576) = 52.8, inside the contract's (K + 16)).  The
// levels and the operator are staged by cp.async through a 3-stage
// shared-memory ring; the dequantize and the split are fused into the
// fragment loads, round, clamp and uint8 into the staging of the tile.
// The tile's shape is chosen from M, bs and d (`launch` below): the fewest
// computed columns, a column tile of whole d-pixel rows where bs > 1, so
// that the tile's pixels fill one contiguous run of each block's output.
// The store (InflateStore) then writes that run in 16-byte chunks, each a
// byte permute of 4 (bs 4) or 8 (bs 2) staged pixels (where d*bs is a
// multiple of 16 and the output 16-byte aligned), else each staged pixel
// to its bs x bs bytes; at bs 1 the tile's rows leave as K5's do.  The
// TPU's 128-lane block packing (kron(I_P, W) operators) and pr-major
// panels were MXU and relayout artifacts and are gone.
#include <cmath>
#include <mutex>
#include <type_traits>

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

// How a launch at bs > 1 lays the product out.  A column tile owns `step`
// of the M product columns (whole d-pixel rows where `chunks`); the output
// has M * bs * bs bytes a block, pixel (i, j) of a block at rows i*bs ..
// i*bs+bs-1 and columns j*bs .. j*bs+bs-1 of its (d*bs)-wide rows.
struct Layout {
  int d, bs, step;
  bool chunks;    // 16-byte chunks of replicated pixels, else pixel by pixel
};

// tc_product's store for K4 at bs > 1: replicate the staged pixels [col0,
// col0 + cols) of each of the tile's blocks to their bs x bs places.
struct InflateStore {
  Layout lay;
  template <class S>
  __device__ __forceinline__ int step() const {
    return lay.step;
  }
  template <class S>
  __device__ __forceinline__ void write(const uint8_t* os,
                                        uint8_t* __restrict__ out, int64_t n,
                                        int M, int64_t row0, int col0,
                                        int tid) const {
    constexpr int kStride = jt::tc::Staged<S, PixelEpi>::kStride;
    const int d = lay.d, bs = lay.bs, W = d * bs;  // W: output row bytes
    const int64_t blk = int64_t(M) * bs * bs;      // output bytes a block
    const int cols = M - col0 < lay.step ? M - col0 : lay.step;
    if (lay.chunks) {
      // The tile holds whole d-pixel rows, so its part of each block is the
      // contiguous run of bytes [col0 * bs * bs, (col0 + cols) * bs * bs);
      // W % 16 == 0, so no 16-byte chunk of it straddles an output row.
      const int row_chunks = W / 16;
      const int chunks = cols / d * bs * row_chunks;  // a block's, this tile
      const int px = 16 / bs;                         // staged pixels a chunk
      uint8_t* base = out + row0 * blk + int64_t(col0) * bs * bs;
      for (int c = tid; c < S::kBM * chunks; c += jt::tc::kThreads) {
        const int r = c / chunks, k = c - r * chunks;
        if (row0 + r >= n) break;
        const int R = k / row_chunks;                 // output row in the run
        const uint8_t* src =
            os + r * kStride + (R / bs) * d + (k - R * row_chunks) * px;
        uint4 v;
        if (bs == 4) {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(src);
          v = make_uint4(__byte_perm(w, 0, 0x0000), __byte_perm(w, 0, 0x1111),
                         __byte_perm(w, 0, 0x2222), __byte_perm(w, 0, 0x3333));
        } else {
          const uint2 w = *reinterpret_cast<const uint2*>(src);
          v = make_uint4(__byte_perm(w.x, 0, 0x1100),
                         __byte_perm(w.x, 0, 0x3322),
                         __byte_perm(w.y, 0, 0x1100),
                         __byte_perm(w.y, 0, 0x3322));
        }
        *reinterpret_cast<uint4*>(base + r * blk + int64_t(k) * 16) = v;
      }
    } else {
      for (int e = tid; e < S::kBM * cols; e += jt::tc::kThreads) {
        const int r = e / cols, c = e - r * cols;
        if (row0 + r >= n) break;
        const int j = col0 + c, p = j / d, q = j - p * d;
        const uint8_t v = os[r * kStride + c];
        uint8_t* dst = out + (row0 + r) * blk + int64_t(p) * bs * W + q * bs;
        for (int y = 0; y < bs; ++y)
          for (int x = 0; x < bs; ++x) dst[y * W + x] = v;
      }
    }
  }
};

template <bool kVec, class S, class Epi, class Store>
__global__ void __launch_bounds__(jt::tc::kThreads, 2)
    decode_blocks_kernel(const int32_t* __restrict__ lv,
                         const int32_t* __restrict__ deq,
                         const float* __restrict__ opt, int64_t n, int K,
                         int M, Store store,
                         typename Epi::Out* __restrict__ out,
                         bool vec_store) {
  jt::tc::tc_product<S, kVec>(reinterpret_cast<const uint32_t*>(lv), opt,
                              n, K, M, DequantA{deq, K}, Epi{}, out,
                              vec_store, store);
}

// The kernel's opt-in to more than 48 KB of dynamic shared memory, once per
// device and instantiation.
template <bool kVec, class S, class Epi, class Store>
cudaError_t opt_in(int device) {
  constexpr int kDevices = 64;
  static std::once_flag once[kDevices];
  static cudaError_t err[kDevices];
  if (device < 0 || device >= kDevices) return cudaErrorInvalidDevice;
  std::call_once(once[device], [device] {
    err[device] = cudaFuncSetAttribute(
        decode_blocks_kernel<kVec, S, Epi, Store>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
  });
  return err[device];
}

// A shape's column step at (M, d, bs): whole d-pixel rows where bs > 1 and
// a row fits the tile, else the tile's width; and the columns its tiles
// compute in all.
template <class S>
int step_of(int M, int d, int bs) {
  if (bs > 1 && d <= S::kBN) return M <= S::kBN ? M : S::kBN / d * d;
  return S::kBN;
}
template <class S>
int64_t computed(int M, int d, int bs) {
  const int step = step_of<S>(M, d, bs);
  return int64_t((M + step - 1) / step) * S::kBN;
}

template <class S, class Epi, class Store>
int launch_store(const void* levels, const void* deq, const void* op_t,
                 int64_t n, int32_t K, int32_t M, int step, Store store,
                 void* out, int32_t device, void* stream) {
  const int64_t tiles =
      ((n + S::kBM - 1) / S::kBM) * int64_t((M + step - 1) / step);
  if (tiles < 1 || tiles > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  using Out = typename Epi::Out;
  const bool vec_store = jt::tc::tc_vec_stores<Out>(out, M);
  const bool vec_loads =
      jt::tc::tc_vec_loads(levels, op_t, K, M) && step % 4 == 0;
  const cudaError_t err = vec_loads ? opt_in<true, S, Epi, Store>(device)
                                    : opt_in<false, S, Epi, Store>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* kernel = vec_loads ? decode_blocks_kernel<true, S, Epi, Store>
                           : decode_blocks_kernel<false, S, Epi, Store>;
  kernel<<<static_cast<unsigned>(tiles), jt::tc::kThreads, S::kSmemBytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(levels), static_cast<const int32_t*>(deq),
      static_cast<const float*>(op_t), n, K, M, store, static_cast<Out*>(out),
      vec_store);
  return static_cast<int>(cudaGetLastError());
}

// bs 1: the tile's rows as they are (RowStore, step S::kBN); bs > 1: the
// inflate store, 16-byte chunks where the tile holds whole rows, bs is 2 or
// 4, d * bs is a multiple of 16 and the output 16-byte aligned.
template <class S, class Epi>
int launch_shape(const void* levels, const void* deq, const void* op_t,
                 int64_t n, int32_t K, int32_t M, int d, int bs, void* out,
                 int32_t device, void* stream) {
  const int step = step_of<S>(M, d, bs);
  if constexpr (std::is_same<typename Epi::Out, uint8_t>::value) {
    if (bs > 1) {
      const bool chunks = step % d == 0 && (bs == 2 || bs == 4) &&
                          (d * bs) % 16 == 0 &&
                          reinterpret_cast<uintptr_t>(out) % 16 == 0;
      return launch_store<S, Epi>(levels, deq, op_t, n, K, M, step,
                                  InflateStore{{d, bs, step, chunks}}, out,
                                  device, stream);
    }
  }
  return launch_store<S, Epi>(levels, deq, op_t, n, K, M, step,
                              jt::tc::RowStore{}, out, device, stream);
}

// The shape that computes the fewest columns at (M, d, bs), the wide tile
// first, then the 96-wide, then the tall one.
template <class Epi>
int launch(const void* levels, const void* deq, const void* op_t, int64_t n,
           int32_t K, int32_t M, int32_t bs, void* out, int32_t device,
           void* stream) {
  using jt::tc::Tall;
  using jt::tc::W96;
  using jt::tc::Wide;
  cudaSetDevice(device);
  int d = 0;
  if (bs > 1) {
    d = static_cast<int>(std::lround(std::sqrt(static_cast<double>(M))));
    if (int64_t(d) * d != M) return static_cast<int>(cudaErrorInvalidValue);
  } else if (bs != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t wide = computed<Wide>(M, d, bs);
  const int64_t w96 = computed<W96>(M, d, bs);
  const int64_t tall = computed<Tall>(M, d, bs);
  if (wide <= w96 && wide <= tall)
    return launch_shape<Wide, Epi>(levels, deq, op_t, n, K, M, d, bs, out,
                                   device, stream);
  if (w96 <= tall)
    return launch_shape<W96, Epi>(levels, deq, op_t, n, K, M, d, bs, out,
                                  device, stream);
  return launch_shape<Tall, Epi>(levels, deq, op_t, n, K, M, d, bs, out,
                                 device, stream);
}

}  // namespace

// out: (N, M * bs * bs) uint8; M must be a square where bs > 1.
JT_API int jt_decode_blocks(const void* levels, const void* deq,
                            const void* op_t, int64_t n, int32_t K,
                            int32_t M, int32_t bs, void* out, int32_t device,
                            void* stream) {
  return launch<PixelEpi>(levels, deq, op_t, n, K, M, bs, out, device,
                          stream);
}

// K4's product without its epilogue: out is (N, M) f32.
JT_API int jt_decode_blocks_sums(const void* levels, const void* deq,
                                 const void* op_t, int64_t n, int32_t K,
                                 int32_t M, void* out, int32_t device,
                                 void* stream) {
  return launch<SumEpi>(levels, deq, op_t, n, K, M, 1, out, device, stream);
}
