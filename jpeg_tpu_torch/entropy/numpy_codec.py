"""Vectorized run-length + bitstream entropy codec (NumPy host path; the same
code as ``jpeg_tpu/entropy/numpy_codec.py``).

Wire format (derived from reference util.py:134-229, pipeline/
run_length_encoding.py, pipeline/rle_byte_stream.py):

For each block (``L = dct_size**2`` coefficients in zigzag order):
  * For every nonzero amplitude ``a`` preceded by ``r`` zeros since the last
    nonzero:
      - ``r // 15`` "zeros chain" units, each the 8 bits ``1111 0000``;
      - one code unit: ``r % 15`` (4 bits) | ``size`` (4 bits) | sign bit
        (``1`` = positive, ``0`` = negative; util.py:120-123) | ``|a|`` in
        exactly ``size - 1`` natural binary bits, MSB first.
        ``size = bit_length(|a|) + 1`` (util.py:156); ``size`` must be <= 15,
        i.e. ``|a| <= 16383``, else the stream is unrepresentable
        (BadRleCodeError, util.py:162-174).
  * An end-of-block marker: 8 zero bits, then zero-padding up to the next
    byte boundary (rle_byte_stream.py:54-56).  Every block therefore starts
    byte-aligned — the property that makes parallel decode and the
    distributed bitstream stitch possible.

Unlike the reference's per-code Python loops, both directions here are
vectorized over *all* codes of a band at once: prefix sums produce bit
offsets, a flat scatter writes bits, and decode advances every block in
lockstep (one vectorized step per code slot).
"""
from __future__ import annotations

import numpy as np

from ..config import BadRleCodeError, BadStreamError

MAX_RUN = 15
MAX_SIZE = 15
MAX_AMP = (1 << (MAX_SIZE - 1)) - 1  # 16383


def _bit_length(abs_vals: np.ndarray) -> np.ndarray:
    """Exact bit length of positive int64 values (< 2**53)."""
    return np.frexp(abs_vals.astype(np.float64))[1].astype(np.int64)


def encode_levels(levels: np.ndarray) -> bytes:
    """Encode (N, L) integer zigzag levels into the band bytestream."""
    levels = np.ascontiguousarray(levels)
    if levels.ndim != 2:
        raise ValueError(f"levels must be (num_blocks, L), got {levels.shape}")
    n_blocks, L = levels.shape

    nzmask = levels != 0
    bid, cid = np.nonzero(nzmask)           # row-major: block order, ascending index
    amp = levels[bid, cid].astype(np.int64)
    absamp = np.abs(amp)

    # Run of zeros before each nonzero (within its block).
    idx = np.arange(L, dtype=np.int64)[None, :]
    marked = np.where(nzmask, idx, np.int64(-1))
    pmax = np.maximum.accumulate(marked, axis=1)
    prev = np.empty_like(pmax)
    prev[:, 0] = -1
    prev[:, 1:] = pmax[:, :-1]
    run = (idx - prev - 1)[bid, cid]

    size = _bit_length(absamp) + 1
    if size.size and int(size.max()) > MAX_SIZE:
        bad = int(absamp.max())
        raise BadRleCodeError(
            f"amplitude {bad} needs size {int(size.max())} > {MAX_SIZE}")

    nchains = run // MAX_RUN
    rrem = run - nchains * MAX_RUN
    code_bits = 8 + size                     # 4 run + 4 size + 1 sign + (size-1) mag
    group_bits = 8 * nchains + code_bits     # chains precede the code

    # Per-block bit/byte geometry (+8 for EOB, pad to byte boundary).
    blk_bits = np.bincount(bid, weights=group_bits.astype(np.float64),
                           minlength=n_blocks).astype(np.int64) + 8
    blk_bytes = (blk_bits + 7) >> 3
    blk_byte_start = np.zeros(n_blocks, dtype=np.int64)
    np.cumsum(blk_bytes[:-1], out=blk_byte_start[1:])
    total_bytes = int(blk_bytes.sum())

    if amp.size == 0:
        return bytes(total_bytes)            # all blocks are a single EOB byte

    # Within-block bit offset of each nonzero's unit group.
    csum = np.cumsum(group_bits)
    excl = csum - group_bits
    first_nz_of_block = np.searchsorted(bid, np.arange(n_blocks))
    base = excl[np.minimum(first_nz_of_block, amp.size - 1)]
    start_bit = blk_byte_start[bid] * 8 + (excl - base[bid])

    # Code unit values, MSB-first over (8 + size) bits.
    sign = (amp > 0).astype(np.int64)
    vals = ((rrem << (4 + size)) | (size << size)
            | (sign << (size - 1)) | absamp)

    # Assemble all variable-length units: chains then codes.
    tot_ch = int(nchains.sum())
    if tot_ch:
        ch_excl = np.cumsum(nchains) - nchains
        ragged = np.arange(tot_ch, dtype=np.int64) - np.repeat(ch_excl, nchains)
        ch_start = np.repeat(start_bit, nchains) + 8 * ragged
        u_start = np.concatenate([ch_start, start_bit + 8 * nchains])
        u_len = np.concatenate([np.full(tot_ch, 8, dtype=np.int64), code_bits])
        u_val = np.concatenate([np.full(tot_ch, 0xF0, dtype=np.int64), vals])
    else:
        u_start, u_len, u_val = start_bit, code_bits, vals

    # Flat bit scatter.
    total_bits = int(u_len.sum())
    len_excl = np.cumsum(u_len) - u_len
    within = np.arange(total_bits, dtype=np.int64) - np.repeat(len_excl, u_len)
    pos = np.repeat(u_start, u_len) + within
    shift = np.repeat(u_len, u_len) - 1 - within
    bits = ((np.repeat(u_val, u_len) >> shift) & 1).astype(np.uint8)

    out = np.zeros(total_bytes * 8, dtype=np.uint8)
    out[pos] = bits
    return np.packbits(out).tobytes()


_U32 = __import__("struct").Struct(">I")


def scan_offsets(data: bytes, num_blocks: int, L: int) -> np.ndarray:
    """Serial O(bytes) boundary scan: validate the stream and return each
    block's start byte offset (pure-Python fallback for the C++
    ``native_codec.scan_offsets``; same error behavior).

    Scanning needs only each code's (run, size) header — the magnitude bits
    are skipped — so the cost is ~one 32-bit word read per code, linear in
    the stream length (the reference decodes serially per code the same way,
    rle_byte_stream.py:74-88).
    """
    buf = bytes(data)
    n = len(buf)
    starts = np.zeros(num_blocks, dtype=np.int32)
    if num_blocks == 0:
        if n:
            raise BadStreamError(
                f"stream has {n} trailing bytes after 0 blocks")
        return starts
    if n == 0:
        raise BadStreamError("empty bytestream")
    pad = buf + b"\x00\x00\x00"          # word reads never run off the end
    unpack = _U32.unpack_from
    nbits = 8 * n
    max_codes = L + L // MAX_RUN + 2
    pos = 0
    for b in range(num_blocks):
        starts[b] = pos >> 3
        widx = 0
        done = False
        for _ in range(max_codes):
            if pos + 8 > nbits:
                raise BadStreamError(f"truncated stream at block {b}")
            w = unpack(pad, pos >> 3)[0] >> (24 - (pos & 7))
            run = (w >> 4) & 0xF
            size = w & 0xF
            if size == 0:
                if run == 0:             # EOB: pad to byte boundary
                    pos = (pos + 15) & ~7
                    done = True
                    break
                if run != MAX_RUN:
                    raise BadRleCodeError(f"({run}, 0, 0)")
                pos += 8                 # zeros chain
                widx += MAX_RUN
                continue
            if pos + 8 + size > nbits:
                raise BadStreamError(f"truncated stream at block {b}")
            pos += 8 + size              # skip sign + magnitude
            widx += run
            if widx >= L:
                raise BadStreamError("coefficient index overflows block")
            widx += 1
        if not done:
            raise BadStreamError("block did not terminate with EOB")
    if pos >> 3 != n:
        raise BadStreamError(
            f"stream has {n - (pos >> 3)} trailing bytes after "
            f"{num_blocks} blocks")
    return starts


def _read4(bits: np.ndarray, pos: np.ndarray) -> np.ndarray:
    v = np.zeros(pos.shape, dtype=np.int64)
    for k in range(4):
        v = (v << 1) | bits[np.minimum(pos + k, bits.size - 1)]
    return v


def _read_amp(bits: np.ndarray, pos: np.ndarray, size: np.ndarray) -> np.ndarray:
    """Read sign + (size-1) magnitude bits starting at ``pos``."""
    sign = bits[np.minimum(pos, bits.size - 1)].astype(np.int64)
    mag = np.zeros(pos.shape, dtype=np.int64)
    for k in range(MAX_SIZE - 1):
        take = k < (size - 1)
        b = bits[np.minimum(pos + 1 + k, bits.size - 1)].astype(np.int64)
        mag = np.where(take, (mag << 1) | b, mag)
    return np.where(sign == 1, mag, -mag)


def decode_levels(data: bytes, num_blocks: int, L: int) -> np.ndarray:
    """Decode a band bytestream into (num_blocks, L) int32 zigzag levels."""
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.zeros((num_blocks, L), dtype=np.int32)
    if num_blocks == 0:
        if buf.size:
            raise BadStreamError(
                f"stream has {buf.size} trailing bytes after 0 blocks")
        return out
    if buf.size == 0:
        raise BadStreamError("empty bytestream")
    bits = np.unpackbits(buf)

    # Phase 1: serial O(bytes) boundary scan (validates the whole stream,
    # including truncation and trailing bytes).
    starts = scan_offsets(data, num_blocks, L).astype(np.int64)

    # Phase 2: lockstep decode of all blocks in parallel.
    pos = starts * 8
    widx = np.zeros(num_blocks, dtype=np.int64)
    done = np.zeros(num_blocks, dtype=bool)
    max_steps = L + L // MAX_RUN + 2
    for _ in range(max_steps):
        active = ~done
        if not active.any():
            break
        run = _read4(bits, pos)
        size = _read4(bits, pos + 4)
        is_eob = (run == 0) & (size == 0)
        is_chain = (run == MAX_RUN) & (size == 0)
        is_code = ~is_eob & ~is_chain
        bad = active & is_code & (size == 0)
        if bad.any():
            r = int(run[bad.argmax()])
            raise BadRleCodeError(f"({r}, 0, 0)")
        amp = _read_amp(bits, pos + 8, size)
        # chains emit 15 zeros; codes emit `run` zeros then the amplitude
        wtarget = widx + run
        store = active & is_code
        if store.any():
            tgt = wtarget[store]
            if int(tgt.max(initial=-1)) >= L:
                raise BadStreamError("coefficient index overflows block")
            out[np.nonzero(store)[0], tgt] = amp[store]
        widx = np.where(active & is_chain, widx + MAX_RUN,
                        np.where(store, wtarget + 1, widx))
        adv = np.where(is_eob | is_chain, 8, 8 + size)
        newpos = pos + adv
        newpos = np.where(is_eob, (newpos + 7) & ~np.int64(7), newpos)
        pos = np.where(active, newpos, pos)
        done |= active & is_eob
    if not done.all():
        raise BadStreamError("block did not terminate with EOB")
    return out
