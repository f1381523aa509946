"""Codec configuration and quantization-method registry (pure Python;
the same classes as ``jpeg_tpu/config.py``).

Wire-format-compatible with the reference configuration objects
(reference: pipeline/__init__.py:13-68).  The quantization method JSON that
travels inside the file header must serialize with *params first, then
``quantization_scheme_name``* (reference: pipeline/__init__.py:36-39), because
``json.dumps`` preserves insertion order and the header bytes are part of the
on-disk format.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional


class BadQuantizationError(Exception):
    pass


class BadArrayShapeError(Exception):
    pass


class EmptyArrayError(Exception):
    pass


class BadRleCodeError(Exception):
    pass


class BadStreamError(Exception):
    pass


#: Valid quantization scheme names -> their accepted keyword params with
#: defaults (reference: pipeline/__init__.py:14-19, quantizers.py).
_QUANT_SCHEMES: Dict[str, Dict[str, Any]] = {
    "none": {},
    "discard": {"keep": 2},
    "divide": {"divisor": 40},
    "qtable": {},
}


class QuantizationMethod:
    """Named quantization scheme plus its parameters.

    ``to_json``/``from_json`` round-trip through the file header
    (reference: pipeline/__init__.py:36-47).
    """

    def __init__(self, name: str, **kwargs: Any):
        if name not in _QUANT_SCHEMES:
            raise BadQuantizationError(f"name {name}, params {kwargs}")
        allowed = _QUANT_SCHEMES[name]
        for key in kwargs:
            if key not in allowed:
                raise BadQuantizationError(f"name {name}, params {kwargs}")
        self.name = name
        # User-passed params only (defaults are NOT serialized, matching the
        # reference where **kwargs captures only explicit arguments).
        self.params = dict(kwargs)

    # Effective parameter values (defaults applied).
    @property
    def keep(self) -> int:
        return int(self.params.get("keep", 2))

    @property
    def divisor(self) -> float:
        return self.params.get("divisor", 40)

    def to_json(self) -> str:
        d = dict(self.params)
        d["quantization_scheme_name"] = self.name
        return json.dumps(d)

    @staticmethod
    def from_json(s: str) -> "QuantizationMethod":
        d = json.loads(s)
        name = d.pop("quantization_scheme_name")
        return QuantizationMethod(name, **d)

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, QuantizationMethod)
                and self.name == other.name and self.params == other.params)

    def __repr__(self) -> str:
        return f"QuantizationMethod({self.name!r}, **{self.params!r})"


@dataclasses.dataclass
class Configuration:
    """Static codec configuration (reference: pipeline/__init__.py:50-64).

    ``width``/``height`` are the *original* image dimensions; all padded /
    subsampled shapes are derived from them (never stored in the stream).
    """

    width: int
    height: int
    block_size: int = 2
    dct_size: int = 8
    transform: str = "DCT"
    quantization: Optional[QuantizationMethod] = None

    def __post_init__(self) -> None:
        if self.quantization is None:
            self.quantization = QuantizationMethod("none")
        elif self.quantization.name == "qtable" and self.dct_size != 8:
            raise BadQuantizationError()
        # The header stores width/height as u16 (file_format layer): a real
        # format constraint we inherit and validate up front.
        if not (0 < self.width < 65536 and 0 < self.height < 65536):
            raise BadArrayShapeError(
                f"image dims {self.width}x{self.height} exceed the u16 header fields")

    # ---- derived geometry (normative formulas: reference
    # pipeline/run_length_encoding.py:80-88, dct_padding.py:12-19) ----

    @property
    def padded_width(self) -> int:
        return padded_size(self.width, self.block_size)

    @property
    def padded_height(self) -> int:
        return padded_size(self.height, self.block_size)

    @property
    def subsampled_width(self) -> int:
        return self.padded_width // self.block_size

    @property
    def subsampled_height(self) -> int:
        return self.padded_height // self.block_size

    @property
    def coeff_width(self) -> int:
        """Width after DCT padding (multiple of dct_size)."""
        return padded_size(self.subsampled_width, self.dct_size)

    @property
    def coeff_height(self) -> int:
        return padded_size(self.subsampled_height, self.dct_size)

    @property
    def blocks_wide(self) -> int:
        return self.coeff_width // self.dct_size

    @property
    def blocks_high(self) -> int:
        return self.coeff_height // self.dct_size

    @property
    def num_blocks(self) -> int:
        return self.blocks_high * self.blocks_wide


def padded_size(size: int, factor: int) -> int:
    """Smallest multiple of ``factor`` >= ``size`` (reference util.py:100-101)."""
    return -(-int(size) // int(factor)) * int(factor)
