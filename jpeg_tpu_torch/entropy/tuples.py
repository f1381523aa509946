"""Tuple-level RLE views: the step API's entropy intermediates.

Counterpart of ``jpeg_tpu/entropy/tuples.py`` (host-side, NumPy and pure
Python, copied).  The reference exposes a flat Python list of
``(run_length, size, amplitude)`` tuples (EOB = ``(0, 0)``) between its RLE
step and its bytestream step.  The codec itself never builds it (the device
encoder, the C++ codec and :mod:`.numpy_codec` work on levels and bytes);
these helpers reproduce it for the step pipeline (``steps.py``), debugging
and tests.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple, Union

import numpy as np

from ..config import BadRleCodeError, BadStreamError
from .numpy_codec import MAX_RUN, MAX_SIZE

Code = Union[Tuple[int, int], Tuple[int, int, int]]

EOB: Code = (0, 0)
ZEROS_CHAIN: Code = (15, 0, 0)


def validate_code(run: int, size: int, amplitude: int) -> None:
    """Reference validation rules (util.py:162-174)."""
    code = f"({run}, {size}, {amplitude})"
    if size == 0 and amplitude != 0:
        raise BadRleCodeError(code)
    if run < 0 or run > MAX_RUN:
        raise BadRleCodeError(code)
    if size < 0 or size > MAX_SIZE:
        raise BadRleCodeError(code)
    if run > 0 and run != MAX_RUN and size == 0 and amplitude == 0:
        raise BadRleCodeError(code)


def encode_block(zigzag: Sequence[float]) -> List[Code]:
    """One block of zigzag coefficients -> RLE codes ending with EOB
    (reference: run_length_encoding.py:14-29, util.py:146-160)."""
    a = np.asarray(np.round(np.real(np.asarray(zigzag))), dtype=np.int64)
    res: List[Code] = []
    prev = -1
    for i in np.nonzero(a)[0]:
        run = int(i) - prev - 1
        amp = int(a[i])
        for _ in range(run // MAX_RUN):
            res.append(ZEROS_CHAIN)
        size = abs(amp).bit_length() + 1
        validate_code(run % MAX_RUN, size, amp)
        res.append((run % MAX_RUN, size, amp))
        prev = int(i)
    res.append(EOB)
    return res


def encode_levels_to_tuples(levels: np.ndarray) -> List[Code]:
    """(N, L) levels -> flat code list for all blocks (RLE step output)."""
    res: List[Code] = []
    for row in np.asarray(levels):
        res.extend(encode_block(row))
    return res


def decode_tuples_to_levels(tuples_list: Iterable[Code], num_blocks: int,
                            L: int) -> np.ndarray:
    """Flat code list -> (num_blocks, L) levels (inverse RLE step)."""
    out = np.zeros((num_blocks, L), dtype=np.int32)
    b = 0
    w = 0
    for t in tuples_list:
        run, size = t[0], t[1]
        amp = t[2] if len(t) > 2 else 0
        validate_code(run, size, amp)
        if run == 0 and size == 0:          # EOB
            b += 1
            w = 0
            continue
        if b >= num_blocks:
            raise BadStreamError("more blocks than expected")
        if run == MAX_RUN and size == 0:
            w += MAX_RUN
            continue
        w += run
        if w >= L:
            raise BadStreamError("coefficient index overflows block")
        out[b, w] = amp
        w += 1
    if b != num_blocks:
        raise BadStreamError(f"expected {num_blocks} blocks, got {b}")
    return out


def tuples_to_bytes(tuples_list: Iterable[Code]) -> bytes:
    """Serialize codes to the bitstream (reference rle_byte_stream.py:48-58)."""
    bits: List[int] = []
    for t in tuples_list:
        run, size = t[0], t[1]
        amp = t[2] if len(t) > 2 else 0
        validate_code(run, size, amp)
        if run == 0 and size == 0:          # EOB: 8 zero bits + byte pad
            bits.extend([0] * 8)
            while len(bits) % 8:
                bits.append(0)
            continue
        bits.extend((run >> k) & 1 for k in range(3, -1, -1))
        bits.extend((size >> k) & 1 for k in range(3, -1, -1))
        if not (run == MAX_RUN and size == 0):
            bits.append(1 if amp > 0 else 0)
            mag = abs(amp)
            bits.extend((mag >> k) & 1 for k in range(size - 2, -1, -1))
    arr = np.array(bits, dtype=np.uint8)
    return np.packbits(arr).tobytes() if arr.size else b""


def bytes_to_tuples(data: bytes) -> List[Code]:
    """Parse the bitstream back to codes (reference rle_byte_stream.py:60-88)."""
    bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8))
    res: List[Code] = []
    pos = 0
    n = bits.size
    while pos < n:
        if pos + 8 > n:
            raise BadStreamError("truncated code")
        run = int(bits[pos] << 3 | bits[pos + 1] << 2
                  | bits[pos + 2] << 1 | bits[pos + 3])
        size = int(bits[pos + 4] << 3 | bits[pos + 5] << 2
                   | bits[pos + 6] << 1 | bits[pos + 7])
        pos += 8
        if run == 0 and size == 0:
            pos = (pos + 7) & ~7            # skip padding to byte boundary
            res.append(EOB)
        elif run == MAX_RUN and size == 0:
            res.append(ZEROS_CHAIN)
        else:
            if pos + size > n:
                raise BadStreamError("truncated amplitude")
            sign = int(bits[pos])
            mag = 0
            for k in range(1, size):
                mag = (mag << 1) | int(bits[pos + k])
            pos += size
            amp = mag if sign == 1 else -mag
            validate_code(run, size, amp)
            res.append((run, size, amp))
    return res
