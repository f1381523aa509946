// The tensor-core f32 product of K4 (decode_blocks.cu) and K5
// (encode_blocks.cu): out[n, m] = epi(n, m, sum_k a(n, k) * op_t[k, m])
// for an (N, K) left operand of 32-bit words, converted by a functor as it
// is read, and a (K, M) f32 operator, both in device memory, with f32
// accuracy from TF32 tensor cores ("3xTF32").
//
// The split.  Every f32 value x is cut into two TF32 pieces as its
// fragment is read from shared memory: x_hi = rna_tf32(x), x_lo =
// rna_tf32(x - x_hi), where rna_tf32 rounds to the 10 explicit mantissa
// bits of TF32, half away from zero (what cvt.rna.tf32.f32 does, done here
// on the bits with two integer operations: (x + kTf32Round) & kTf32Mask),
// and x - x_hi is exact in f32.  So, for every normal f32 x (integers,
// K5's fractional pixel means and its cos/sin operator alike),
//   |x - x_hi| <= 2^-11 |x|,
//   |x - x_hi - x_lo| <= 2^-22 |x|.
// An integer below 2^22 splits exactly into the two pieces (x - x_hi is an
// integer of at most 2^10); from 2^22 up to 2^24 the residual is at most 1,
// within 2^-22 |x| (three pieces would be exact; the third one's product is
// of the size of the dropped x_lo * y_lo and goes with it).
//
// Each k8 step of each output computes on the tensor cores
//   d = a_hi b_hi + (a_hi b_lo + (a_lo b_hi + 0))
// (three mma.sync.m16n8k8 TF32, the small products first) and adds d to an
// f32 register accumulator with a round-to-nearest add.  The error bound,
// with u = 2^-23 (EPS32 of utils/parity.py) and S = sum_k |a_k b_k| over
// the output's K terms:
// - dropped terms: a_lo b_lo, a's residual times b, b's residual times
//   a_hi + a_lo, each at most 2^-22 (1 + 2^-10) |a b|: 6.01 u S in all;
// - tensor-core sums: products of TF32 pieces are exact in f32.  NVIDIA
//   does not document how an mma sums its j <= 8 products and its addend,
//   so assume each is aligned to the largest exponent and truncated to f32
//   precision, and the sum truncated once more: at most (j + 2) u times the
//   sum of their magnitudes.  The a_hi b_hi step: (j + 2)(1 + 2^-9) u
//   S_step; the two small steps 2^-10 of that together: 1.003 (j + 2) u
//   S_step, j = min(K, 8);
// - register accumulation: ceil(K / 8) round-to-nearest adds, each at most
//   u / 2 of a partial sum within 1.003 S: 0.51 ceil(K / 8) u S.
// Together |acc - sum_k a_k b_k| <= B(K) u S, with
//   B(K) = 1.003 (min(K, 8) + 2) + 0.51 ceil(K / 8) + 6.01,
// 20.1 at K = 64 and 52.8 at K = 576, below the contract's K + 16 (80 and
// 592; utils/parity.py, which also covers the operands' f32 rounding) at
// every K >= 1.  The reset of d at every k8 step is what keeps the bound:
// accumulating all K on the tensor cores would give about 1.13 K, above
// K + 16 at K = 576.  An epilogue that scales the sum (K5's mul / div)
// scales its error by the same factor.
//
// The tiles.  A thread block of 8 warps takes a Shape: 64 rows x 128
// columns (2 x 4 warps; K4, and K5 at L > 64), 128 rows x 64 columns
// (4 x 2 warps; K5 at L <= 64, where a 128-column tile would be half
// zero-filled, and K4 at d = 8) or 64 rows x 96 columns (2 x 4 warps of
// 32 x 24; K4 at d = 24, whose 576 columns it covers in whole 24-column
// rows of pixels, six tiles and no column wasted); warp tiles of 32 rows
// (2 m16 tiles) by 32 or 24 columns (4 or 3 n8 tiles; 32 or 24
// accumulators a thread), K in slices of 32 through a 3-stage ring of
// shared memory filled by cp.async (16-byte copies when K and M are
// multiples of 4 and the operands are 16-byte aligned, else 4-byte copies;
// ragged edges zero-filled).  Shared rows are padded (A: 36 words; B: BN +
// 8 words) so that every fragment load is free of bank conflicts.  On an
// H100 this beat, at K4's main-path and d = 24 shapes, splitting each
// staged slice once into shared {hi, lo} pairs (more shared-memory
// traffic, and a barrier or a second buffer between the split and the
// products), slices of 16, a fourth stage and 128 x 128 tiles, and the
// register-blocked SIMT design (benchmarks/torch_k4_designs.py times that
// one against it).  The tile a block computes does not change any sum: an
// output's K order, split and steps are the same in every shape.  The
// epilogue stages the tile in shared memory, then writes it as rows with
// 16-byte stores where the output rows are 16-byte aligned, else element by
// element (or hands it to the caller's store: K4's writes each pixel to
// its bs x bs places).  Where
// the conversion runs is the epilogue's Epi::kStaged: false converts each
// sum in registers before the staging (K4's round and clamp); true stages
// the raw f32 sums and converts them as the rows leave, four consecutive
// columns a thread.  On an H100 the second made K5 (an IEEE multiply and
// divide a sum) faster and K4's main path slower.  The grid is 1-D with
// the column tiles of a row tile adjacent, so the row tile's A is read from
// device memory once and from L2 by its neighbours.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace jt {
namespace tc {

constexpr int kBK = 32;                  // contraction slice per stage
constexpr int kStages = 3;               // cp.async ring depth
constexpr int kWM = 32;                  // warp tile rows
constexpr int kWN = 32;                  // warp tile columns (the default)
constexpr int kMT = kWM / 16;            // m16 tiles a warp
constexpr int kThreads = 256;            // 8 warps, every shape
constexpr int kAStride = kBK + 4;        // words
constexpr uint32_t kTf32Round = 0x1000u;
constexpr uint32_t kTf32Mask = 0xffffe000u;

static_assert(kBK % 8 == 0 && kWM % 16 == 0, "mma tiling");
static_assert(kAStride % 32 == 4, "conflict-free A fragment loads");

// A thread block's tile: BM rows x BN output columns, in warp tiles of kWM
// rows x WN columns.
template <int BM, int BN, int WN = kWN>
struct Shape {
  static constexpr int kBM = BM;
  static constexpr int kBN = BN;
  static constexpr int kWN = WN;
  static constexpr int kNT = WN / 8;                        // n8 tiles a warp
  static constexpr int kWarpsM = BM / kWM;
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kBStride = BN + 8;                   // words
  static constexpr int kStageWords = BM * kAStride + kBK * kBStride;
  static constexpr int kSmemBytes = kStages * kStageWords * 4;
  static_assert(BM % kWM == 0 && BN % WN == 0 && WN % 8 == 0, "warp tiling");
  static_assert(32 * kWarpsM * kWarpsN == kThreads, "8 warps");
  static_assert(kBStride % 32 == 8, "conflict-free B fragment loads");
};
using Wide = Shape<64, 128>;    // 79,872 bytes of shared memory
using Tall = Shape<128, 64>;    // 82,944 bytes
using W96 = Shape<64, 96, 24>;  // 67,584 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 (or 4) bytes to shared memory, or zeros when !valid (src is then
// not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x's two TF32 pieces, {hi, lo}.
__device__ __forceinline__ uint2 split_tf32(float x) {
  const uint32_t hi = (__float_as_uint(x) + kTf32Round) & kTf32Mask;
  const uint32_t lo =
      (__float_as_uint(x - __uint_as_float(hi)) + kTf32Round) & kTf32Mask;
  return make_uint2(hi, lo);
}

// d = a (16x8, row) * b (8x8, col) + c, TF32 operands, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2],
                                         const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// Stage the A slice [row0, row0 + BM) x [k0, k0 + kBK) and the B slice
// [k0, k0 + kBK) x [col0, col0 + BN) into one ring stage.
template <class S, bool kVec>
__device__ __forceinline__ void load_stage(uint32_t* As, float* Bs,
                                           const uint32_t* __restrict__ a,
                                           const float* __restrict__ b,
                                           int64_t n, int K, int M,
                                           int64_t row0, int col0, int k0) {
  const int tid = threadIdx.x;
  if (kVec) {
#pragma unroll
    for (int c = tid; c < S::kBM * kBK / 4; c += kThreads) {
      const int r = c / (kBK / 4), kc = (c % (kBK / 4)) * 4;
      const bool ok = row0 + r < n && k0 + kc < K;
      cp_async16(As + r * kAStride + kc,
                 ok ? a + (row0 + r) * K + k0 + kc : a, ok);
    }
#pragma unroll
    for (int c = tid; c < kBK * S::kBN / 4; c += kThreads) {
      const int kk = c / (S::kBN / 4), nc = (c % (S::kBN / 4)) * 4;
      const bool ok = k0 + kk < K && col0 + nc < M;
      cp_async16(Bs + kk * S::kBStride + nc,
                 ok ? b + int64_t(k0 + kk) * M + col0 + nc : b, ok);
    }
  } else {
#pragma unroll
    for (int e = tid; e < S::kBM * kBK; e += kThreads) {
      const int r = e / kBK, kk = e % kBK;
      const bool ok = row0 + r < n && k0 + kk < K;
      cp_async4(As + r * kAStride + kk, ok ? a + (row0 + r) * K + k0 + kk : a,
                ok);
    }
#pragma unroll
    for (int e = tid; e < kBK * S::kBN; e += kThreads) {
      const int kk = e / S::kBN, c = e % S::kBN;
      const bool ok = k0 + kk < K && col0 + c < M;
      cp_async4(Bs + kk * S::kBStride + c,
                ok ? b + int64_t(k0 + kk) * M + col0 + c : b, ok);
    }
  }
}

// The tile as the epilogue stages it in shared memory: converted outputs,
// or the raw sums (Epi::kStaged), kStride elements a row.
template <class S, class Epi>
struct Staged {
  using Out = typename Epi::Out;
  using T = typename std::conditional<Epi::kStaged, float, Out>::type;
  static constexpr int kStride = S::kBN + 16 / static_cast<int>(sizeof(T));
  static_assert(S::kBM * kStride * sizeof(T) <= S::kSmemBytes, "out tile");
};

// tc_product's output by default: column tiles of S::kBN, each written as
// rows of the (n, M) output.  Another store gives its own step (the
// columns a tile owns, at most S::kBN) and writes the staged tile with its
// own write(os, out, n, M, row0, col0, tid).
struct RowStore {
  template <class S>
  __device__ __forceinline__ int step() const {
    return S::kBN;
  }
};

// One thread block's S::kBM x S::kBN tile of the product.  conv(word, k)
// -> float converts an A word of column k (it is given 0 for the
// zero-filled edge); epi(row, col, acc) -> Epi::Out is called for outputs
// in range, before (Epi::kStaged false) or after (true) the tile is staged
// in shared memory; `store` takes the tile's columns and writes it (the
// RowStore's rows: 16-byte stores where vec_store).  Needs S::kSmemBytes
// of dynamic shared memory.
template <class S, bool kVec, class Conv, class Epi, class Store = RowStore>
__device__ __forceinline__ void tc_product(const uint32_t* __restrict__ a,
                                           const float* __restrict__ b,
                                           int64_t n, int K, int M, Conv conv,
                                           Epi epi,
                                           typename Epi::Out* __restrict__ out,
                                           bool vec_store,
                                           Store store = Store{}) {
  using Out = typename Epi::Out;
  constexpr int kBM = S::kBM, kBN = S::kBN, kBStride = S::kBStride;
  constexpr int kNT = S::kNT;
  constexpr int kStageWords = S::kStageWords;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem);

  const int step = store.template step<S>();
  const int col_tiles = (M + step - 1) / step;
  const int64_t tile = blockIdx.x;
  const int64_t row0 = (tile / col_tiles) * kBM;
  const int col0 = static_cast<int>(tile % col_tiles) * step;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / S::kWarpsN, wn = warp % S::kWarpsN;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int ktiles = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) {
      uint32_t* st = ring + s * kStageWords;
      load_stage<S, kVec>(st, reinterpret_cast<float*>(st + kBM * kAStride),
                          a, b, n, K, M, row0, col0, s * kBK);
    }
    cp_async_commit();
  }

  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {  // refill the stage every warp finished with at the barrier above
      const int nk = kt + kStages - 1;
      if (nk < ktiles) {
        uint32_t* st = ring + (nk % kStages) * kStageWords;
        load_stage<S, kVec>(st, reinterpret_cast<float*>(st + kBM * kAStride),
                            a, b, n, K, M, row0, col0, nk * kBK);
      }
      cp_async_commit();
    }
    const uint32_t* As = ring + (kt % kStages) * kStageWords;
    const float* Bs = reinterpret_cast<const float*>(As + kBM * kAStride);
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 8) {
      uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float* c = Bs + (ks + t) * kBStride + wn * S::kWN + j * 8 + g;
        const uint2 b0 = split_tf32(c[0]), b1 = split_tf32(c[4 * kBStride]);
        bh[j][0] = b0.x;
        bl[j][0] = b0.y;
        bh[j][1] = b1.x;
        bl[j][1] = b1.y;
      }
      const int k_lo = kt * kBK + ks + t, k_hi = k_lo + 4;
      uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const uint32_t* r = As + (wm * kWM + i * 16 + g) * kAStride + ks + t;
        const uint2 p[4] = {split_tf32(conv(r[0], k_lo)),
                            split_tf32(conv(r[8 * kAStride], k_lo)),
                            split_tf32(conv(r[4], k_hi)),
                            split_tf32(conv(r[8 * kAStride + 4], k_hi))};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ah[i][e] = p[e].x;
          al[i][e] = p[e].y;
        }
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          float d[4];
          mma_tf32(d, al[i], bh[j], zero);
          mma_tf32(d, ah[i], bl[j], d);
          mma_tf32(d, ah[i], bh[j], d);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += d[e];
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // Epilogue: the tile through shared memory (converted, or the raw sums),
  // then the store.
  using Stage = Staged<S, Epi>;
  constexpr int kOutStride = Stage::kStride;
  typename Stage::T* os = reinterpret_cast<typename Stage::T*>(smem);
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wm * kWM + i * 16 + g + (e >> 1) * 8;
        const int c = wn * S::kWN + j * 8 + 2 * t + (e & 1);
        if constexpr (Epi::kStaged) {
          os[r * kOutStride + c] = acc[i][j][e];
        } else {
          const int64_t gr = row0 + r;
          const int gc = col0 + c;
          os[r * kOutStride + c] =
              (gr < n && gc < M) ? epi(gr, gc, acc[i][j][e]) : Out(0);
        }
      }
  __syncthreads();
  if constexpr (!std::is_same<Store, RowStore>::value) {
    store.template write<S>(os, out, n, M, row0, col0, tid);
    return;
  }
  const int cols = M - col0 < kBN ? M - col0 : kBN;
  if (vec_store) {
    constexpr int kChunk = 16 / static_cast<int>(sizeof(Out));
    constexpr int kChunks = kBN / kChunk;
    for (int c = tid; c < kBM * kChunks; c += kThreads) {
      const int r = c / kChunks, cc = (c % kChunks) * kChunk;
      if (row0 + r < n && cc < cols) {
        uint4* dst =
            reinterpret_cast<uint4*>(out + (row0 + r) * M + col0 + cc);
        if constexpr (Epi::kStaged) {
          union {
            uint4 v;
            Out o[kChunk];
          } u;
#pragma unroll
          for (int q = 0; q < kChunk; q += 4) {
            const float4 v = *reinterpret_cast<const float4*>(
                os + r * kOutStride + cc + q);
            const int64_t gr = row0 + r;
            const int gc = col0 + cc + q;
            u.o[q] = epi(gr, gc, v.x);
            u.o[q + 1] = epi(gr, gc + 1, v.y);
            u.o[q + 2] = epi(gr, gc + 2, v.z);
            u.o[q + 3] = epi(gr, gc + 3, v.w);
          }
          *dst = u.v;
        } else {
          *dst = *reinterpret_cast<const uint4*>(os + r * kOutStride + cc);
        }
      }
    }
  } else {
    for (int e = tid; e < kBM * kBN; e += kThreads) {
      const int r = e / kBN, c = e % kBN;
      if (row0 + r < n && c < cols) {
        if constexpr (Epi::kStaged)
          out[(row0 + r) * M + col0 + c] =
              epi(row0 + r, col0 + c, os[r * kOutStride + c]);
        else
          out[(row0 + r) * M + col0 + c] = os[r * kOutStride + c];
      }
    }
  }
}

// The 1-D launch grid of tc_product<S>, or false where it overflows.
template <class S>
inline bool tc_grid(int64_t n, int M, unsigned* blocks) {
  const int64_t tiles =
      ((n + S::kBM - 1) / S::kBM) * int64_t((M + S::kBN - 1) / S::kBN);
  if (tiles < 1 || tiles > 0x7fffffff) return false;
  *blocks = static_cast<unsigned>(tiles);
  return true;
}

// 16-byte copies are legal: K and M multiples of 4, operands 16-aligned.
inline bool tc_vec_loads(const void* a, const void* b, int K, int M) {
  return K % 4 == 0 && M % 4 == 0 &&
         reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

// 16-byte stores are legal: output rows of a multiple of 16 bytes, 16-aligned.
// (Every shape's column tiles are multiples of 16 bytes, so every chunk of
// a row starts 16-aligned.)
template <class Out>
inline bool tc_vec_stores(const void* out, int M) {
  return (int64_t(M) * sizeof(Out)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

}  // namespace tc
}  // namespace jt
