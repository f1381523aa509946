// One block's bitstream writer, shared by the two encode kernels (K1
// encode_stream.cu, K9 encode_tables.cu).
//
// Bits accumulate MSB first in a 64-bit register and leave it as whole
// big-endian 32-bit words of the block's row: byte 0 of the block in bits
// 31..24 of word 0.  Between appends fewer than 32 bits are pending, so an
// append of up to 32 bits never overflows the register.  Words past the
// row's W are counted (`total`) but not stored: the caller checks the block
// bytes against 4 * W and raises.
#pragma once

#include "common.cuh"

namespace jt {

struct BitWriter {
  uint32_t* row;
  int W;
  int wi = 0;          // next word of the row
  int nacc = 0;        // bits pending in acc, < 32 between appends
  uint64_t acc = 0;
  int64_t total = 0;   // bits appended so far

  __device__ BitWriter(uint32_t* r, int w) : row(r), W(w) {}

  // Append the low `nbits` (0..32) bits of val, MSB first; val has no
  // bits above them.
  __device__ void append(int nbits, uint32_t val) {
    acc = (acc << nbits) | val;
    nacc += nbits;
    total += nbits;
    if (nacc >= 32) {
      nacc -= 32;
      uint32_t w = static_cast<uint32_t>(acc >> nacc);
      if (wi < W) row[wi] = w;
      ++wi;
      acc &= (uint64_t(1) << nacc) - 1;
    }
  }

  // Flush the pending bits, zero-padded, and zero the rest of the row.
  __device__ void finish() {
    if (nacc > 0) {
      uint32_t w = static_cast<uint32_t>(acc << (32 - nacc));
      if (wi < W) row[wi] = w;
      ++wi;
    }
    for (int k = wi; k < W; ++k) row[k] = 0;
  }
};

}  // namespace jt
