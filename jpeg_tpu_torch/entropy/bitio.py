"""Host bit-IO classes: the reference's code objects.

Counterpart of ``jpeg_tpu/entropy/bitio.py`` (host-side, pure Python and
NumPy, copied).  The codec never builds these (the device encoder, the C++
codec and :mod:`.numpy_codec` work on levels and bytes), but the reference
exposes ``BitEncoder``, ``BitDecoder``, ``RunLengthBlock`` and
``RunLengthCode`` as public API, so callers written against it keep working.
They run over a small dependency-free ``Bits`` buffer (the reference needs
the ``bitarray`` package).
"""
from __future__ import annotations

from typing import Iterable, List

import numpy as np

from .tuples import MAX_RUN, validate_code


class Bits:
    """Minimal growable bit buffer (bitarray-compatible subset)."""

    def __init__(self, init="") -> None:
        if isinstance(init, Bits):
            self._b: List[bool] = list(init._b)
        elif isinstance(init, str):
            self._b = [c == "1" for c in init]
        else:
            self._b = [bool(x) for x in init]

    def append(self, v) -> None:
        self._b.append(bool(v))

    def extend(self, other: Iterable) -> None:
        self._b.extend(other._b if isinstance(other, Bits)
                       else (bool(x) for x in other))

    def to01(self) -> str:
        return "".join("1" if x else "0" for x in self._b)

    def tobytes(self) -> bytes:
        if not self._b:
            return b""
        return np.packbits(np.asarray(self._b, dtype=np.uint8)).tobytes()

    def frombytes(self, data: bytes) -> None:
        self._b.extend(
            bool(b) for b in np.unpackbits(np.frombuffer(data, np.uint8)))

    def __len__(self) -> int:
        return len(self._b)

    def __getitem__(self, i):
        if isinstance(i, slice):
            out = Bits()
            out._b = self._b[i]
            return out
        return self._b[i]

    def __add__(self, other: "Bits") -> "Bits":
        out = Bits(self)
        out.extend(other)
        return out

    def __eq__(self, other) -> bool:
        return isinstance(other, Bits) and self._b == other._b

    def __repr__(self) -> str:
        return f"Bits('{self.to01()}')"


class BitEncoder:
    """Integer -> bit patterns (reference util.py:115-132)."""

    def encode_unsigned(self, x: int) -> Bits:
        return Bits(bin(abs(int(x)))[2:])

    def encode_signed(self, x: int) -> Bits:
        # Leading '1' marks POSITIVE (reference util.py:120-123).
        return Bits(("1" if x > 0 else "0") + bin(abs(int(x)))[2:])

    def pad_bitstring(self, bits: Bits, size: int = 4) -> Bits:
        out = Bits("0" * max(0, size - len(bits)))
        out.extend(bits)
        return out


class BitDecoder:
    """Streaming bit reader (reference pipeline/rle_byte_stream.py:6-41)."""

    def __init__(self, bits: Bits) -> None:
        self._bits = bits
        self._pos = 0

    def read(self, n: int) -> Bits:
        out = self._bits[self._pos:self._pos + n]
        self._pos += n
        return out

    def read_quad(self) -> Bits:
        return self.read(4)

    def decode_unsigned(self, n: int) -> int:
        bits = self.read(n)
        return int(bits.to01() or "0", 2)

    def decode_signed(self, n: int) -> int:
        bits = self.read(n).to01()
        mag = int(bits[1:] or "0", 2)
        return mag if bits[0] == "1" else -mag

    def skip_padding(self) -> None:
        self._pos = (self._pos + 7) & ~7

    def is_end(self) -> bool:
        return self._pos >= len(self._bits)


class RunLengthBlock:
    """Per-block RLE encode/decode over code objects
    (reference pipeline/run_length_encoding.py:6-40)."""

    def __init__(self, block_size: int):
        self._size = block_size

    def encode(self, zigzag_array) -> List["RunLengthCode"]:
        a = np.asarray(np.round(np.real(np.asarray(zigzag_array))), np.int64)
        res: List[RunLengthCode] = []
        prev = -1
        for i in np.nonzero(a)[0]:
            res.extend(RunLengthCode.encode(int(i) - prev - 1, int(a[i])))
            prev = int(i)
        res.append(RunLengthCode.EOB())
        return res

    def decode(self, rle_block) -> np.ndarray:
        out: List[int] = []
        for code in rle_block:
            if code.is_EOB():
                out.extend([0] * (self._size - len(out)))
                break
            out.extend(code.decode())
        return np.array(out)


class RunLengthCode:
    """(run_length, size, amplitude) code object (reference util.py:134-229)."""

    max_run_length = MAX_RUN

    def __init__(self, run_length: int, size: int, amplitude: int = 0):
        validate_code(run_length, size, amplitude)
        self.run_length = run_length
        self.size = size
        self.amplitude = amplitude

    @staticmethod
    def EOB() -> "RunLengthCode":
        return RunLengthCode(0, 0, 0)

    @staticmethod
    def all_zeros() -> "RunLengthCode":
        return RunLengthCode(MAX_RUN, 0, 0)

    @staticmethod
    def encode(run_length: int, amplitude: int) -> List["RunLengthCode"]:
        """Nonzero amplitude after ``run_length`` zeros -> chain+code list
        (reference util.py:146-160; run==15 yields chain then (0,s,a))."""
        res = [RunLengthCode.all_zeros()
               for _ in range(run_length // MAX_RUN)]
        size = int(abs(int(amplitude))).bit_length() + 1
        res.append(RunLengthCode(run_length % MAX_RUN, size, amplitude))
        return res

    def is_EOB(self) -> bool:
        return self.run_length == 0 and self.size == 0

    def is_zeros_chain(self) -> bool:
        return (self.run_length == MAX_RUN and self.size == 0
                and self.amplitude == 0)

    def decode(self) -> List[int]:
        if self.is_zeros_chain():
            return [0] * MAX_RUN
        return [0] * self.run_length + [self.amplitude]

    def as_tuple(self):
        if self.is_EOB():
            return 0, 0
        amp = self.amplitude
        if not np.iscomplex(amp):
            amp = int(round(amp))
        return self.run_length, self.size, amp

    def as_bitstring(self) -> Bits:
        if self.is_EOB():
            return Bits("0" * 8)
        enc = BitEncoder()
        out = enc.pad_bitstring(enc.encode_unsigned(self.run_length))
        out.extend(enc.pad_bitstring(enc.encode_unsigned(self.size)))
        if not self.is_zeros_chain():
            out.extend(enc.encode_signed(self.amplitude))
        return out

    # The reference's (sic) misspelled method name, kept for drop-in use.
    as_bitsring = as_bitstring

    def __eq__(self, other) -> bool:
        return (self.run_length == other.run_length
                and self.size == other.size
                and self.amplitude == other.amplitude)

    def __repr__(self) -> str:
        return f"({self.run_length}, {self.size}, {self.amplitude})"
