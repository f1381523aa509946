"""Binary container format — byte-identical to the reference writer/reader
(the same code as ``jpeg_tpu/container.py``).

Layout (all integers little-endian; reference file_format.py:67-111):

    u16 header_length            (= 2 + 13 + len(quant_json))
    u16 width
    u16 height
    u16 block_size
    u16 dct_size
    3-byte ASCII transform name  ('DCT' / 'DFT')
    u16 quant_json_length
    ASCII quantization JSON      (params first, then quantization_scheme_name)
    u32 y_len,  y bytes
    u32 cb_len, cb bytes
    u32 cr_len, cr bytes
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Tuple

from .config import Configuration, QuantizationMethod


@dataclasses.dataclass
class CompressedData:
    y: bytes
    cb: bytes
    cr: bytes


class Reader:
    """Sequential byte reader (drop-in for reference file_format.py:5-19)."""

    def __init__(self, seq: bytes):
        self._seq = seq
        self._index = 0

    def read(self, n: int) -> bytes:
        chunk = self._seq[self._index:self._index + n]
        self._index += n
        return chunk

    def read_short(self) -> bytes:
        return self.read(2)

    def read_long(self) -> bytes:
        return self.read(4)


# Field pack/unpack helpers (reference file_format.py:43-64): little-endian
# u16 ("integer"), u32 ("long"), ASCII strings.
def pack_integer(value: int) -> bytes:
    return struct.pack("<H", value)


def unpack_integer(bytestream: bytes) -> int:
    return struct.unpack("<H", bytestream)[0]


def pack_long(value: int) -> bytes:
    return struct.pack("<L", value)


def unpack_long(bytestream: bytes) -> int:
    return struct.unpack("<L", bytestream)[0]


def pack_string(s: str) -> bytes:
    return bytes(s, encoding="ascii")


def unpack_string(bytestream: bytes) -> str:
    return bytestream.decode()


def create_header(config: Configuration) -> bytes:
    quant_json = config.quantization.to_json()
    header_length = 2 + 13 + len(quant_json)
    return (struct.pack("<H", header_length)
            + struct.pack("<H", config.width)
            + struct.pack("<H", config.height)
            + struct.pack("<H", config.block_size)
            + struct.pack("<H", config.dct_size)
            + config.transform.encode("ascii")
            + struct.pack("<H", len(quant_json))
            + quant_json.encode("ascii"))


def get_header(bytestream: bytes) -> Configuration:
    (_header_length, width, height, block_size, dct_size) = struct.unpack_from(
        "<HHHHH", bytestream, 0)
    transform = bytestream[10:13].decode("ascii")
    (quant_len,) = struct.unpack_from("<H", bytestream, 13)
    quant_json = bytestream[15:15 + quant_len].decode("ascii")
    quantization = QuantizationMethod.from_json(quant_json)
    return Configuration(width=width, height=height, block_size=block_size,
                         dct_size=dct_size, transform=transform,
                         quantization=quantization)


def generate_data(config: Configuration, data: CompressedData) -> bytes:
    return (create_header(config)
            + struct.pack("<L", len(data.y)) + data.y
            + struct.pack("<L", len(data.cb)) + data.cb
            + struct.pack("<L", len(data.cr)) + data.cr)


def read_band_spans(bytestream: bytes
                    ) -> Tuple[Configuration, Tuple[Tuple[int, int], ...]]:
    """:func:`read_data`'s parse without its copies: the configuration and
    each band's ``(offset, length)`` in ``bytestream``, a length cut where
    the container ends, as a slice is.  It raises what :func:`read_data`
    raises."""
    config = get_header(bytestream)
    (header_length,) = struct.unpack_from("<H", bytestream, 0)
    pos = header_length

    spans = []
    for _ in range(3):
        (blen,) = struct.unpack_from("<L", bytestream, pos)
        pos += 4
        spans.append((pos, min(blen, len(bytestream) - pos)))
        pos += blen
    return config, tuple(spans)


def read_data(bytestream: bytes) -> Tuple[Configuration, CompressedData]:
    config, spans = read_band_spans(bytestream)
    return config, CompressedData(
        *(bytes(bytestream[pos:pos + n]) for pos, n in spans))
