// Native entropy codec for jpeg_tpu: run-length + bitstream pack/unpack.
//
// Wire format documented in ../numpy_codec.py (derived from the reference's
// util.py RunLengthCode / rle_byte_stream.py).  Every block is byte-aligned:
// codes for nonzero coefficients ((run%15) 4b | size 4b | sign 1b |
// magnitude size-1 bits, preceded by run/15 chain bytes 0xF0), then an EOB
// byte-aligned 0x00 + zero padding.
//
// Exposed via a tiny C ABI consumed through ctypes (no pybind11 in image).
//
// Error codes (negative returns):
//   -1  output capacity too small (encode)
//   -2  amplitude out of range (|a| > 16383)         [BadRleCodeError]
//   -3  invalid code in stream (run>0, !=15, size=0)  [BadRleCodeError]
//   -4  coefficient index overflows block             [BadStreamError]
//   -5  truncated stream                              [BadStreamError]
//   -6  block did not terminate / too many codes      [BadStreamError]

#include <cstdint>
#include <cstring>

namespace {

constexpr int kMaxRun = 15;
constexpr int kMaxSize = 15;
constexpr int32_t kMaxAmp = (1 << (kMaxSize - 1)) - 1;  // 16383

inline int bit_length(uint32_t v) {
#if defined(__GNUC__)
    return v ? 32 - __builtin_clz(v) : 0;
#else
    int n = 0;
    while (v) { ++n; v >>= 1; }
    return n;
#endif
}

// MSB-first bit writer over a byte buffer.
struct BitWriter {
    uint8_t* buf;
    int64_t capacity;   // bytes
    int64_t bitpos = 0;
    bool overflow = false;

    inline void put(uint32_t value, int nbits) {
        if (((bitpos + nbits + 7) >> 3) > capacity) { overflow = true; return; }
        if (nbits == 0) return;
        // Word-window deposit, MSB-first: position the value inside the
        // byte window covering [bitpos, bitpos+nbits) and OR it in (the
        // buffer is zero-initialized and fields never overlap).
        int64_t byte0 = bitpos >> 3;
        int off = int(bitpos & 7);
        int need = off + nbits;                // <= 7 + 32
        int nb = (need + 7) >> 3;
        uint64_t w = uint64_t(value) << (int64_t(nb) * 8 - need);
        for (int i = nb - 1; i >= 0; --i) {
            buf[byte0 + i] |= uint8_t(w & 0xFFu);
            w >>= 8;
        }
        bitpos += nbits;
    }
    inline void align_byte() { bitpos = (bitpos + 7) & ~int64_t(7); }
};

// MSB-first bit reader.
struct BitReader {
    const uint8_t* buf;
    int64_t nbits;
    int64_t bitpos = 0;

    inline bool have(int n) const { return bitpos + n <= nbits; }
    inline uint32_t get(int nbits_) {
        // Word-window extraction: load the <=5 bytes covering the field and
        // shift once, instead of a per-bit loop (~5x faster parse; the
        // caller's have() guarantees the last touched byte is in bounds).
        if (nbits_ == 0) return 0;
        int64_t byte0 = bitpos >> 3;
        int off = int(bitpos & 7);
        int need = off + nbits_;               // <= 7 + 32
        int nb = (need + 7) >> 3;              // bytes covering the field
        uint64_t w = 0;
        for (int i = 0; i < nb; ++i) w = (w << 8) | buf[byte0 + i];
        w >>= (int64_t(nb) * 8 - need);
        bitpos += nbits_;
        uint64_t mask = (nbits_ >= 64) ? ~0ull : ((1ull << nbits_) - 1ull);
        return uint32_t(w & mask);
    }
    inline void align_byte() { bitpos = (bitpos + 7) & ~int64_t(7); }
};

}  // namespace

extern "C" {

// Encode (n_blocks x L) int32 zigzag levels. Returns bytes written or <0.
int64_t jt_encode(const int32_t* levels, int64_t n_blocks, int64_t L,
                  uint8_t* out, int64_t out_capacity) {
    std::memset(out, 0, size_t(out_capacity));
    BitWriter w{out, out_capacity};
    for (int64_t b = 0; b < n_blocks; ++b) {
        const int32_t* row = levels + b * L;
        int64_t run = 0;
        for (int64_t i = 0; i < L; ++i) {
            int32_t a = row[i];
            if (a == 0) { ++run; continue; }
            uint32_t absa = uint32_t(a < 0 ? -int64_t(a) : a);
            if (absa > uint32_t(kMaxAmp)) return -2;
            while (run >= kMaxRun) { w.put(0xF0u, 8); run -= kMaxRun; }
            int size = bit_length(absa) + 1;
            w.put(uint32_t(run), 4);
            w.put(uint32_t(size), 4);
            w.put(a > 0 ? 1u : 0u, 1);
            w.put(absa, size - 1);
            run = 0;
        }
        w.put(0u, 8);   // EOB
        w.align_byte();
        if (w.overflow) return -1;
    }
    return w.bitpos >> 3;
}

// Upper bound on encoded size for capacity allocation.
int64_t jt_encode_bound(int64_t n_blocks, int64_t L) {
    // per block: every coeff nonzero -> L*(8+15) bits, plus worst-case
    // chains 8*(L/15) bits, plus EOB + padding.
    int64_t bits = L * (8 + kMaxSize) + 8 * (L / kMaxRun + 1) + 16;
    return n_blocks * ((bits + 7) / 8) + 16;
}

// Scan block boundaries only: record each block's start byte offset into
// starts[n_blocks], validating the stream but not materializing levels.
// This is the only serial part of decode; the per-coefficient work can then
// run data-parallel per block (e.g. on the TPU, entropy/device_codec.py).
// Returns bytes consumed or <0 (same error codes as jt_decode).
int64_t jt_scan_offsets(const uint8_t* data, int64_t n_bytes,
                        int32_t* starts, int64_t n_blocks, int64_t L) {
    BitReader r{data, n_bytes * 8};
    const int64_t max_codes = L + L / kMaxRun + 2;
    for (int64_t b = 0; b < n_blocks; ++b) {
        starts[b] = int32_t(r.bitpos >> 3);
        int64_t widx = 0;
        bool done = false;
        for (int64_t step = 0; step < max_codes; ++step) {
            if (!r.have(8)) return -5;
            uint32_t run = r.get(4);
            uint32_t size = r.get(4);
            if (run == 0 && size == 0) { r.align_byte(); done = true; break; }
            if (run == kMaxRun && size == 0) { widx += kMaxRun; continue; }
            if (size == 0) return -3;
            if (!r.have(int(size))) return -5;
            r.bitpos += size;                 // skip sign + magnitude
            widx += run;
            if (widx >= L) return -4;
            ++widx;
        }
        if (!done) return -6;
    }
    return r.bitpos >> 3;
}

// Decode into (n_blocks x L) int32. Returns bytes consumed or <0.
int64_t jt_decode(const uint8_t* data, int64_t n_bytes,
                  int32_t* out, int64_t n_blocks, int64_t L) {
    std::memset(out, 0, size_t(n_blocks * L) * sizeof(int32_t));
    BitReader r{data, n_bytes * 8};
    const int64_t max_codes = L + L / kMaxRun + 2;
    for (int64_t b = 0; b < n_blocks; ++b) {
        int32_t* row = out + b * L;
        int64_t widx = 0;
        bool done = false;
        for (int64_t step = 0; step < max_codes; ++step) {
            if (!r.have(8)) return -5;
            uint32_t run = r.get(4);
            uint32_t size = r.get(4);
            if (run == 0 && size == 0) {          // EOB
                r.align_byte();
                done = true;
                break;
            }
            if (run == kMaxRun && size == 0) {    // zeros chain
                widx += kMaxRun;
                continue;
            }
            if (size == 0) return -3;             // (run, 0, 0), run not 0/15
            if (!r.have(int(size))) return -5;
            uint32_t sign = r.get(1);
            uint32_t mag = size > 1 ? r.get(int(size - 1)) : 0;
            widx += run;
            if (widx >= L) return -4;
            row[widx++] = sign ? int32_t(mag) : -int32_t(mag);
        }
        if (!done) return -6;
    }
    return r.bitpos >> 3;
}

}  // extern "C"
