// The lane-parallel bit writer shared by the two encode kernels (K1
// encode_stream.cu, K9 encode_tables.cu).
//
// A group of G consecutive lanes of one warp (G = 1, 4, 8, 16 or 32)
// writes one block's row.  Lane k owns the slots [k m, min((k + 1) m, S)),
// m = ceil(S / G), of the block's S slots and the contiguous range of bits
// they produce: a sum-scan of the lanes' bit counts over the group gives
// each lane its first bit.  Rows are big-endian 32-bit words, byte 0 of the
// block in bits 31..24 of word 0, zero-padded to W words.  Each lane's
// bits accumulate MSB first in a 64-bit register that starts at its first
// bit's phase in the word, and leave as whole words: a word inside the
// lane's range is stored, a word it shares with a neighbour (its first,
// when the range starts inside it, and its last, unfinished one) is OR'd
// into the row, which is zeroed first.  Words past W are counted, not
// stored: the caller checks the block bytes against 4 * W.  A lane visits
// only the slots that code something: it reads its slots 32 at a time into
// a mask and walks the mask's set bits.  G = 1 is one thread a block, with
// the same staging, writing as it counts.
//
// A thread block takes a tile of consecutive blocks: their tables (K1: the
// levels; K9: the group lengths and their low words) are staged into
// shared memory with 4-byte asynchronous copies, coalesced, at an odd
// stride so that lanes reading slot j of neighbouring blocks hit different
// banks; the rows are staged there too
// when they fit (kEncRowMaxWords) and leave with coalesced 16-byte stores,
// zeros included, else the lanes write the global row.  The plan
// (ops/kernels.py `encode_rows_plan`) picks G, the tile and the row's place.
#pragma once

#include "common.cuh"

namespace jt {

constexpr int kEncThreads = 128;      // ops/kernels.py ENC_THREADS
constexpr int kEncRowMaxWords = 512;  // ENC_ROW_MAX_WORDS: a staged row
constexpr int kEncDefaultSmem = 48 << 10;
constexpr int kEncMaxSmem = 227 << 10;  // ENC_MAX_SMEM: an H100's opt-in
constexpr unsigned kFullMask = 0xffffffffu;

// Inclusive sum and max over the G lanes of a group (lane = its index).
template <int G>
__device__ __forceinline__ int group_sum(int v, int lane) {
#pragma unroll
  for (int d = 1; d < G; d <<= 1) {
    const int u = __shfl_up_sync(kFullMask, v, d, G);
    if (lane >= d) v += u;
  }
  return v;
}

template <int G>
__device__ __forceinline__ int group_max(int v, int lane) {
#pragma unroll
  for (int d = 1; d < G; d <<= 1) {
    const int u = __shfl_up_sync(kFullMask, v, d, G);
    if (lane >= d) v = max(v, u);
  }
  return v;
}

// The value of lane - 1 (`none` for lane 0), and of the group's last lane.
template <int G>
__device__ __forceinline__ int group_before(int v, int lane, int none) {
  if (G == 1) return none;
  const int u = __shfl_up_sync(kFullMask, v, 1, G);
  return lane == 0 ? none : u;
}

template <int G>
__device__ __forceinline__ int group_last(int v) {
  return G == 1 ? v : __shfl_sync(kFullMask, v, G - 1, G);
}

// Calls f(s) for each slot s of [s0, s1) whose value passes keep, in
// order: the slots are read 32 at a time into a mask, whose set bits are
// then visited, so a lane's loop runs once a code, not once a slot.
template <typename Keep, typename F>
__device__ __forceinline__ void for_each_kept(const int32_t* v, int s0,
                                              int s1, Keep keep, F f) {
  for (int c0 = s0; c0 < s1; c0 += 32) {
    const int n = min(32, s1 - c0);
    uint32_t mask = 0;
    if (n == 32) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        mask |= static_cast<uint32_t>(keep(v[c0 + i])) << i;
    } else {
      for (int i = 0; i < n; ++i)
        mask |= static_cast<uint32_t>(keep(v[c0 + i])) << i;
    }
    while (mask != 0) {
      const int i = __ffs(mask) - 1;
      mask &= mask - 1;
      f(c0 + i);
    }
  }
}

// One lane's writer over its bit range, which starts at bit `bit0` of the
// row (in shared or global memory).
struct LaneWriter {
  uint32_t* row;
  int W;
  int wi;              // word the accumulator fills next
  int first;           // the lane's first word
  bool first_shared;   // ... which the lane before may share
  int nacc;            // bits pending in acc, < 32 between appends
  uint64_t acc = 0;

  __device__ LaneWriter(uint32_t* r, int w, int bit0)
      : row(r), W(w), wi(bit0 >> 5), first(bit0 >> 5),
        first_shared((bit0 & 31) != 0), nacc(bit0 & 31) {}

  __device__ __forceinline__ void put(uint32_t w, bool shared) {
    if (wi < W) {
      if (shared) {
        atomicOr(row + wi, w);
      } else {
        row[wi] = w;
      }
    }
    ++wi;
  }

  // Append the low `nbits` (0..32) bits of val, MSB first; val has no
  // bits above them.
  __device__ __forceinline__ void append(int nbits, uint32_t val) {
    acc = (acc << nbits) | val;
    nacc += nbits;
    if (nacc >= 32) {
      nacc -= 32;
      put(static_cast<uint32_t>(acc >> nacc), first_shared && wi == first);
      acc &= (uint64_t(1) << nacc) - 1;
    }
  }

  // The bit the next append starts at (bits since bit 0 of the row).
  __device__ __forceinline__ int bits() const { return 32 * wi + nacc; }

  // The pending bits: the range's last word, which the next lane may share.
  __device__ __forceinline__ void finish() {
    if (nacc > 0 && acc != 0)
      put(static_cast<uint32_t>(acc << (32 - nacc)), true);
  }
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// The tile's shared memory: its rows (tile x W words, when staged), its
// block bytes (tile), and `tables` tables of tile rows of S slots at stride
// S | 1 (K1: the levels; K9: the group lengths, then their low words).
struct EncTile {
  uint32_t* rows;
  int32_t* bytes;
  int32_t* table;
  int32_t* values;   // the second table
  int stride;

  __host__ __device__ static int round4(int x) { return (x + 3) & ~3; }
  __host__ __device__ static int64_t smem_bytes(int tile, int S, int W,
                                                bool smem_rows, int tables) {
    return 4 * (int64_t(smem_rows ? round4(tile * W) : 0) + round4(tile) +
                int64_t(tables) * tile * (S | 1));
  }
  __device__ EncTile(int4* smem, int tile, int S, int W, bool smem_rows) {
    uint32_t* p = reinterpret_cast<uint32_t*>(smem);
    rows = p;
    p += smem_rows ? round4(tile * W) : 0;
    bytes = reinterpret_cast<int32_t*>(p);
    table = bytes + round4(tile);
    stride = S | 1;
    values = table + tile * stride;
  }

  // Stage rows [0, nb) of the (nb, S) int32 table at src into dst (a
  // table of the tile), coalesced, with 4-byte asynchronous copies.
  __device__ void stage(int32_t* dst, const int32_t* __restrict__ src,
                        int nb, int S) const {
    if (S == 0) return;
    const int q = blockDim.x / S, r = blockDim.x % S;
    int b = threadIdx.x / S, j = threadIdx.x % S;
    const int count = nb * S;
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      cp_async4(dst + b * stride + j, src + i);
      b += q;
      j += r;
      if (j >= S) {
        j -= S;
        ++b;
      }
    }
  }

  // Wait for this thread's copies (the caller syncs the block).
  __device__ static void wait_staged() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                     : "memory");
  }
};

// Zero `count` words at p (16-byte aligned), all threads of the block.
__device__ __forceinline__ void zero_words(uint32_t* p, int count) {
  int4* v = reinterpret_cast<int4*>(p);
  for (int i = threadIdx.x; i < count / 4; i += blockDim.x)
    v[i] = make_int4(0, 0, 0, 0);
  for (int i = (count / 4) * 4 + threadIdx.x; i < count; i += blockDim.x)
    p[i] = 0;
}

// Store `count` staged words (16-byte aligned) to dst, coalesced: 16-byte
// stores when `vec` (dst 16-byte aligned), all threads of the block.
__device__ __forceinline__ void store_words(uint32_t* __restrict__ dst,
                                            const uint32_t* src, int count,
                                            bool vec) {
  int i0 = 0;
  if (vec) {
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
    for (int i = threadIdx.x; i < count / 4; i += blockDim.x) d[i] = s[i];
    i0 = (count / 4) * 4;
  }
  for (int i = i0 + threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

// Launch geometry for a tile plan; 0 on success, else a cudaError_t.
struct EncLaunch {
  unsigned grid = 0;
  int threads = 0;
  size_t smem = 0;
};

inline int enc_launch(int64_t n, int S, int W, int lanes, int tile,
                      bool smem_rows, int tables, EncLaunch* out) {
  if (n < 1 || S < 0 || W < 1 || tile < 1 || lanes < 1 || lanes > 32 ||
      lanes == 2 || (lanes & (lanes - 1)) != 0 ||
      (smem_rows && W > kEncRowMaxWords))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t want = int64_t(tile) * lanes;
  const int threads = static_cast<int>(want < kEncThreads ? want
                                                          : kEncThreads);
  const int64_t tiles = (n + tile - 1) / tile;
  const int64_t smem = EncTile::smem_bytes(tile, S, W, smem_rows, tables);
  if (threads % 32 != 0 || tile % (threads / lanes) != 0 ||
      (lanes == 1 && tile > kEncThreads) ||
      tiles > 0x7fffffff || smem > kEncMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  out->grid = static_cast<unsigned>(tiles);
  out->threads = threads;
  out->smem = static_cast<size_t>(smem);
  return 0;
}

// Launch kern (one of the kernels for G = 1, 4, 8, 16, 32, in that order:
// two lanes a block never beat one or four) with the plan's geometry,
// opting in to the shared memory.
template <typename Kern, typename... Args>
int enc_run(const Kern* kernels, int tables, int64_t n, int S, int W,
            int lanes, int tile, bool smem_rows, void* stream, Args... args) {
  EncLaunch g;
  const int err = enc_launch(n, S, W, lanes, tile, smem_rows, tables, &g);
  if (err != 0) return err;
  const int log2_lanes = 31 - __builtin_clz(static_cast<unsigned>(lanes));
  const Kern kern = kernels[lanes == 1 ? 0 : log2_lanes - 1];
  if (g.smem > size_t(kEncDefaultSmem)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(g.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<g.grid, g.threads, g.smem, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace jt
