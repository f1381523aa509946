// The boundary scan's walk of one block with the host scanner's rules
// (entropy/native/entropy.cpp `jt_scan_offsets`), the bit buffer its
// walkers read headers through from global memory, and the staging of a
// tile of stream bytes into shared memory.  K6 and K6' (scan_walk.cu) and
// K10 (segment_scan.cu) run this one `walk()`, so the rules are in one
// place.
#pragma once

#include "common.cuh"

namespace jt {

enum : int { kLive = 0, kDone = 1, kErr = 2 };

// One walker's headers from global memory through a 64-bit bit buffer:
// `buf` holds the stream bits from position `base` on (bits from the
// block's first bit), MSB first, and takes the next big-endian word when a
// header starts 32 bits or more into it.  Positions only move forward, at
// most 23 bits a unit, so one word a header at most keeps the header
// inside the buffer.
struct StreamBits {
  const uint8_t* s;
  int64_t n;
  bool aligned;        // s is 4-byte aligned: whole words load at once
  int64_t base;
  int64_t next;        // the stream word after the buffer
  uint64_t buf;

  __device__ __forceinline__ uint32_t word(int64_t w) const {
    const int64_t b = 4 * w;
    if (aligned && b >= 0 && b + 4 <= n)
      return __byte_perm(__ldg(reinterpret_cast<const uint32_t*>(s) + w), 0,
                         0x0123);
    uint32_t v = 0;
    for (int j = 0; j < 4; ++j)
      v = (v << 8) | ((b + j >= 0 && b + j < n) ? s[b + j] : 0u);
    return v;
  }
  // Start at position `pos` of the block whose first bit is `start`.
  __device__ __forceinline__ void seek(int64_t start, int64_t pos) {
    const int64_t w = (start + pos) >> 5;
    base = w * 32 - start;
    buf = (uint64_t(word(w)) << 32) | word(w + 1);
    next = w + 2;
  }
  // Positions from now on count from the block `bytes` bytes after the
  // current one.  The buffer stays: after a walk that read its EOB header
  // at position pos (pos - base < 32), the next block, ceil((pos + 8) / 8)
  // bytes on, starts fewer than 47 bits past `base`.
  __device__ __forceinline__ void next_block(int64_t bytes) {
    base -= 8 * bytes;
  }
  __device__ __forceinline__ uint32_t header(int64_t bit) {
    int64_t off = bit - base;
    if (off >= 32) {
      buf = (buf << 32) | word(next++);
      base += 32;
      off -= 32;
    }
    return static_cast<uint32_t>(buf >> (56 - off)) & 0xFFu;
  }
};

// Walk one block from bit `pos` with coefficient index `widx` for at most
// `units` units, bits below `limit`.  Returns kDone (pos at the EOB
// header), kErr (pos and widx where the rejected unit starts) or kLive
// (the unit budget ran out).  `Pos` is the integer type of the positions:
// int64 for bits from a block's start, int32 for bits counted from a tile.
template <class Bytes, class Pos>
__device__ __forceinline__ int walk(Bytes& bytes, Pos limit, int L,
                                    int units, Pos& pos, int& widx) {
  for (int unit = 0; unit < units; ++unit) {
    if (pos + 8 > limit) return kErr;                 // truncated header
    const uint32_t h = bytes.header(pos);
    if (h == 0) return kDone;                         // EOB
    if (h == 0xF0) {                                  // zero-run chain
      widx += kMaxRun;
      pos += 8;
      continue;
    }
    const int run = static_cast<int>(h >> 4);
    const int size = static_cast<int>(h & 0xF);
    if (size == 0) return kErr;                       // (run, 0) code
    if (pos + 8 + size > limit) return kErr;          // truncated code
    if (widx + run >= L) return kErr;                 // index overflow
    widx += run + 1;
    pos += 8 + size;
  }
  return kLive;
}

// The host scanner's unit budget for one block.
__device__ __forceinline__ int max_units(int L) {
  return L + L / kMaxRun + 2;
}

// dst[i] = src[first + i] for first + i < valid, else 0, for i < count
// (a multiple of 16; first too).
__device__ __forceinline__ void stage_bytes(uint8_t* __restrict__ dst,
                                            const uint8_t* __restrict__ src,
                                            int64_t first, int count,
                                            int64_t valid) {
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (int i = threadIdx.x * 16; i < count; i += blockDim.x * 16) {
    const int64_t g = first + i;
    if (aligned && g + 16 <= valid) {
      *reinterpret_cast<uint4*>(dst + i) =
          __ldg(reinterpret_cast<const uint4*>(src + g));
    } else {
      for (int j = 0; j < 16; ++j) dst[i + j] = g + j < valid ? src[g + j] : 0;
    }
  }
}

}  // namespace jt
