"""Quantizers as elementwise functions over zigzag-ordered coefficients.

All four reference quantizers are elementwise (or a static per-position
mask/table), so they commute with the zigzag permutation and run right after
the fused transform, on zigzag-ordered tables:

  * 'none'    round(a)
  * 'discard' round(a), zero rows/cols >= keep
  * 'divide'  round(a / float(divisor)); restore a * divisor
  * 'qtable'  round(a * (1.0/q)); restore a * q, 8x8 only

``round`` is round-half-to-even (``torch.round``, as ``np.round``).  The
qtable reciprocal is built in float64 and then cast to the working dtype,
exactly as ``jpeg_tpu/ops/quantize.py`` does: dividing by the table instead
would move values across .5 boundaries.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import QuantizationMethod
from .transform import zigzag_permutation

MAX_AMP = (1 << 14) - 1  # largest codable |amplitude|

#: Standard JPEG luminance quantization table hardcoded by the reference.
JPEG_QTABLE = np.array(
    [[16, 11, 10, 16, 24, 40, 51, 61],
     [12, 12, 14, 19, 26, 58, 60, 55],
     [14, 13, 16, 24, 40, 57, 69, 56],
     [14, 17, 22, 29, 51, 87, 80, 62],
     [18, 22, 37, 56, 68, 109, 103, 77],
     [24, 35, 55, 64, 81, 104, 113, 92],
     [49, 64, 78, 87, 103, 121, 120, 101],
     [72, 92, 95, 98, 112, 100, 103, 99]], dtype=np.float64)


@functools.lru_cache(maxsize=None)
def qtable_zigzag(n: int = 8) -> np.ndarray:
    """JPEG table flattened in zigzag order (n must be 8)."""
    if n != 8:
        raise ValueError(f"the JPEG table is 8x8, got dct_size {n}")
    return JPEG_QTABLE.reshape(-1)[zigzag_permutation(n)]


@functools.lru_cache(maxsize=None)
def discard_mask_zigzag(n: int, keep: int) -> np.ndarray:
    """1.0 where block row < keep and col < keep, else 0.0; zigzag order."""
    rows = np.arange(n)[:, None]
    cols = np.arange(n)[None, :]
    mask = ((rows < keep) & (cols < keep)).astype(np.float64)
    return mask.reshape(-1)[zigzag_permutation(n)]


def epilogue(coeffs_zz: torch.Tensor, mul: torch.Tensor, div: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """``round(c * mul / div) * mask`` with vectors from
    :func:`epilogue_vectors` cast to the coefficients' dtype.  Bitwise equal
    to each quantizer's own expression (``jpeg_tpu/ops/quantize.py:
    quantize``): the unit factors multiply and divide by 1.0 exactly."""
    return torch.round(coeffs_zz * mul / div) * mask


def quantize(coeffs_zz: torch.Tensor, method: QuantizationMethod,
             dct_size: int) -> torch.Tensor:
    """Elementwise quantization of zigzag coefficients (float -> float), in
    their dtype: ``round(c / divisor)`` is a true division (the divisor is
    an (L,) tensor, never a host scalar, which CUDA would turn into a
    reciprocal multiply) and the qtable's is ``round(c * (1/q))``."""
    mul, div, mask = (torch.as_tensor(v, dtype=coeffs_zz.dtype,
                                      device=coeffs_zz.device)
                      for v in epilogue_vectors(method, dct_size))
    return epilogue(coeffs_zz, mul, div, mask)


def epilogue_vectors(method: QuantizationMethod, dct_size: int):
    """(mul, div, mask) f64 vectors s.t. quantize == round(c*mul/div)*mask
    (the factored form the tie contract, ``utils/parity.py``, models)."""
    L = dct_size * dct_size
    mul = np.ones(L)
    div = np.ones(L)
    mask = np.ones(L)
    name = method.name
    if name == "discard":
        mask = discard_mask_zigzag(dct_size, method.keep)
    elif name == "divide":
        div = float(method.divisor) * mul
    elif name == "qtable":
        mul = 1.0 / qtable_zigzag(dct_size)
    elif name != "none":
        raise ValueError(name)
    return mul, div, mask


def dequant_int_vector(method: QuantizationMethod, dct_size: int):
    """(L,) int64 multiplier with dequantize == levels * vec, or None.

    None when the restore step is not an integer multiply (a float divisor,
    which truncates) or when the int32 product could wrap; the block-decode
    kernel (``ops/kernels.py:decode_blocks``) needs the integer form.
    """
    L = dct_size * dct_size
    name = method.name
    if name in ("none", "discard"):
        return np.ones(L, np.int64)
    if name == "divide":
        d = method.divisor
        # int32 kernel multiply must not wrap: require |amp|*d < 2**31.
        if float(d) == int(d) and int(d) <= (2 ** 31 - 1) // MAX_AMP:
            return int(d) * np.ones(L, np.int64)
        return None
    if name == "qtable":
        return qtable_zigzag(dct_size).astype(np.int64)
    raise ValueError(name)


def dequantize(levels_zz: torch.Tensor, method: QuantizationMethod,
               dct_size: int, parity: bool = False) -> torch.Tensor:
    """Inverse ('restore') step on integer levels (``jpeg_tpu/ops/
    quantize.py:dequantize``).

    The reference stores restored values back into its int levels array,
    so a non-integer divisor's product truncates toward zero.  The parity
    mode computes in int64 / f64 and returns int64.  The f32 mode returns
    the levels' integer dtype for exact integer products, and f32 where
    the JAX package's f32 mode does: ``trunc(f32(level) * divisor)`` for a
    non-integer divisor, and ``f32(level) * divisor`` for an integer one
    whose int32 product could wrap."""
    name = method.name
    if name in ("none", "discard"):
        return levels_zz
    if name == "divide":
        d = method.divisor
        if float(d) == int(d):
            if parity or int(d) <= (2 ** 31 - 1) // MAX_AMP:
                return levels_zz * int(d)
            return levels_zz.to(torch.float32) * float(d)
        ftype = torch.float64 if parity else torch.float32
        prod = torch.trunc(levels_zz.to(ftype) * float(d))
        return prod.to(levels_zz.dtype) if parity else prod
    if name == "qtable":
        q = torch.as_tensor(qtable_zigzag(dct_size).astype(np.int64),
                            dtype=levels_zz.dtype, device=levels_zz.device)
        return levels_zz * q
    raise ValueError(name)


class RoundingQuantizer:
    """The reference's quantizer objects, on one (d, d) block in NumPy:
    ``quantize`` rounds, ``restore`` is the identity."""

    def quantize(self, a):
        return np.round(a)

    def restore(self, a):
        return a


class DiscardingQuantizer(RoundingQuantizer):
    """Round, then zero all rows / columns >= keep."""

    def __init__(self, keep: int = 2):
        self.keep = keep

    def quantize(self, a):
        res = np.round(np.asarray(a)).copy()
        res[self.keep:] = 0
        res[:, self.keep:] = 0
        return res


class DivisionQuantizer(RoundingQuantizer):
    """round(a / divisor); restore a * divisor."""

    def __init__(self, divisor: float = 40):
        self.divisor = divisor

    def quantize(self, a):
        return np.round(np.asarray(a) / float(self.divisor))

    def restore(self, a):
        return np.asarray(a) * self.divisor


class JpegQuantizationTable(RoundingQuantizer):
    """The standard 8x8 luminance table: round(a * (1/q)); restore
    round(a * q)."""

    table = JPEG_QTABLE

    def quantize(self, a):
        return np.round(np.asarray(a) * (1.0 / JPEG_QTABLE))

    def restore(self, a):
        return np.round(np.asarray(a) * JPEG_QTABLE)


#: Scheme name -> quantizer class.
QUANTIZER_CLASSES = {
    "none": RoundingQuantizer,
    "discard": DiscardingQuantizer,
    "divide": DivisionQuantizer,
    "qtable": JpegQuantizationTable,
}


def quantizer_for(method: QuantizationMethod):
    """The quantizer object for a :class:`QuantizationMethod`."""
    return QUANTIZER_CLASSES[method.name](**method.params)
