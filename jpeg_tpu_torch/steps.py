"""The reference's invertible, ordered step pipeline, on torch tensors.

Counterpart of ``jpeg_tpu/steps.py``.  The reference structures the codec
as a totally ordered list of invertible steps, registered when a subclass
of :class:`AlgorithmStep` is defined and sorted by its mandatory
``step_index`` (a subclass without one raises
:class:`MissingStepIndexError`).  :func:`compress_band_steps` runs every
``execute`` in ascending order, :func:`decompress_band_steps` every
``invert`` in descending order.  Subclass :class:`AlgorithmStep` with a new
``step_index`` to splice a custom step in.

Steps 0-6 are torch ops on the step's ``device`` over the whole plane at
once; steps 7-8 (the variable-length entropy views) are host lists and
bytes, as the reference's list of tuples and bitstream.  The codec's own
path (``ops/band.py``) is the fast one; this view is for extension,
debugging intermediates and step-level parity tests.

Every step takes ``device`` (``"cuda"`` by default, or ``"cpu"``) and
``dtype``: ``None`` (f32) or ``torch.float64``, the parity mode, in which
every intermediate equals the reference's bit for bit: the transforms run
on the host in the reference's evaluation order (``ops/transform.py``
``exact_*``), and every division is a true division by a tensor.  The JAX
package reads the same choice from ``jax_enable_x64``.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .config import (BadArrayShapeError, Configuration, EmptyArrayError,
                     padded_size)
from .entropy import tuples as TU
from .ops import blocks as B
from .ops import quantize as Q
from .ops import transform as T
from .utils.device import full_f32_matmul, resolve_device, resolve_dtype


class MissingStepIndexError(Exception):
    """A subclass of :class:`AlgorithmStep` has no ``step_index``."""


class IndexOutOfOrderError(Exception):
    """Reserved, as in the reference's exception surface."""


#: Ordered registry of all step classes.
step_classes: List[type] = []


def _check_2d(a: torch.Tensor) -> torch.Tensor:
    """``a``, once it is a non-empty 2-D tensor (the JAX package's
    ``ops/blocks.py:_check_2d``)."""
    if a.dim() != 2:
        raise BadArrayShapeError(tuple(a.shape))
    if a.shape[0] == 0 or a.shape[1] == 0:
        raise EmptyArrayError()
    return a


def _blockify(a: torch.Tensor, block_size: int) -> torch.Tensor:
    """(H, W) -> (H/b, W/b, b, b), edge-padding first."""
    return B.blockify(_check_2d(a), block_size)


def _round_preserving_complex(a: torch.Tensor) -> torch.Tensor:
    if a.is_complex():
        return torch.complex(torch.round(a.real), torch.round(a.imag))
    return torch.round(a)


def _real_op(a: torch.Tensor, fn) -> torch.Tensor:
    """``fn`` on a real tensor, or on the real and imaginary parts of a
    complex one: the JAX package's complex products and quotients by a
    real factor give exactly these values."""
    if a.is_complex():
        return torch.complex(fn(a.real), fn(a.imag))
    return fn(a)


class AlgorithmStep:
    """Base class; subclasses register themselves sorted by
    ``step_index``."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if "step_index" not in cls.__dict__:
            raise MissingStepIndexError(
                f'Class {cls.__name__} has not defined "step_index" '
                f"class attribute")
        step_classes.append(cls)
        step_classes.sort(key=lambda c: c.step_index)

    def __init__(self, config: Configuration, device="cuda", dtype=None):
        self._config = config
        self._device = resolve_device(device)
        self._dtype = resolve_dtype(dtype)

    def execute(self, array):
        raise NotImplementedError

    def invert(self, array):
        raise NotImplementedError

    # Shared helpers of the reference's base class.
    def calculate_padding(self, factor: int):
        w, h = self._config.width, self._config.height
        return padded_size(h, factor) - h, padded_size(w, factor) - w

    def blocks(self, a, block_size: int):
        """Yield (block, y, x) over the block grid."""
        tiles = _blockify(self._tensor(a), block_size)
        for y in range(tiles.shape[0]):
            for x in range(tiles.shape[1]):
                yield tiles[y, x], y, x

    def apply_blockwise(self, a, transformation, block_size: int, res=None):
        """Apply ``transformation`` to every block, vectorised over the
        block grid (``torch.vmap``); ``res`` (a NumPy array), if given, is
        filled too."""
        tiles = _blockify(self._tensor(a), block_size)
        plane = B.deblockify(torch.vmap(torch.vmap(transformation))(tiles))
        if res is not None:
            res[...] = plane.cpu().numpy()
        return plane

    def _tensor(self, a) -> torch.Tensor:
        """A step's input as a tensor on the step's device."""
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.asarray(a))
        return a.to(self._device)

    def _parity(self) -> bool:
        return self._dtype == torch.float64

    def _tiled(self, table_2d: np.ndarray, shape) -> torch.Tensor:
        """A (d, d) table repeated over an (H, W) plane, on the device."""
        d = self._config.dct_size
        return torch.from_numpy(table_2d).tile(
            (shape[0] // d, shape[1] // d)).to(self._device)


class Padding(AlgorithmStep):
    """Edge-replicate to a multiple of block_size."""

    step_index = 0

    def execute(self, array):
        a = self._tensor(array)
        if self._config.block_size == 1:
            return a
        return B.pad_edge_hw(_check_2d(a), self._config.block_size)

    def invert(self, array):
        return array[:self._config.height, :self._config.width]


class SubSampling(AlgorithmStep):
    """Mean-pool block_size tiles; the inverse is a nearest-neighbour
    inflate.  Applied to every band, luma included."""

    step_index = 1

    def execute(self, array):
        return B.subsample(self._tensor(array).to(self._dtype),
                           self._config.block_size)

    def invert(self, array):
        return B.inflate(array, self._config.block_size)


class DCTPadding(AlgorithmStep):
    """Edge-replicate the subsampled plane to a multiple of dct_size."""

    step_index = 2

    def execute(self, array):
        return B.pad_edge_hw(_check_2d(self._tensor(array)),
                             self._config.dct_size)

    def invert(self, array):
        cfg = self._config
        return array[:cfg.subsampled_height, :cfg.subsampled_width]


class Normalization(AlgorithmStep):
    """Forward identity; the inverse clamps to [0, 255]."""

    step_index = 3

    def execute(self, array):
        return array

    def invert(self, array):
        return torch.clamp(array, 0, 255)


class BasisChange(AlgorithmStep):
    """Blockwise 2-D DCT (real) or DFT (complex); the inverse rounds to
    integers."""

    step_index = 4

    def _host(self, exact, blk: torch.Tensor, dtype) -> torch.Tensor:
        """A reference-order host transform of the blocks, back on the
        device."""
        out = exact(blk.to(dtype).cpu().numpy(), self._config.dct_size)
        return torch.from_numpy(out).to(self._device)

    def _product(self, blk: torch.Tensor, op: np.ndarray) -> torch.Tensor:
        """(NV, NH, d, d) blocks times a row-major (d*d, d*d) operator, in
        full f32."""
        nv, nh, d, _ = blk.shape
        op_t = torch.from_numpy(op.T.astype(np.float32)).to(self._device)
        with full_f32_matmul():
            out = torch.matmul(blk.reshape(nv, nh, d * d).to(torch.float32),
                               op_t)
        return out.reshape(nv, nh, d, d)

    def execute(self, array):
        d = self._config.dct_size
        blk = _blockify(self._tensor(array), d)       # (NV, NH, d, d)
        if self._config.transform == "DCT":
            if self._parity():
                out = self._host(T.exact_dct2_blocks, blk, torch.float64)
            else:
                out = self._product(blk, T.kron_operator(d))
        elif self._config.transform == "DFT":
            if self._parity():
                out = self._host(T.exact_fft2_blocks, blk, torch.complex128)
            else:
                out = torch.fft.fft2(blk.to(torch.float32))
        else:
            raise ValueError(self._config.transform)
        return B.deblockify(out)

    def invert(self, array):
        d = self._config.dct_size
        blk = _blockify(self._tensor(array), d)
        if self._config.transform == "DCT":
            if self._parity():
                out = self._host(T.exact_idct2_blocks, blk, torch.float64)
            else:
                out = self._product(blk, T.kron_inverse_operator(d))
        elif self._config.transform == "DFT":
            if self._parity():
                out = self._host(T.exact_ifft2_blocks, blk, torch.complex128)
            else:
                out = torch.fft.ifft2(blk.to(torch.complex64))
            out = out.real
        else:
            raise ValueError(self._config.transform)
        # Round, then the integer cast; clamping is the next step's invert.
        itype = torch.int64 if self._parity() else torch.int32
        return torch.round(B.deblockify(out)).to(itype)


class Quantization(AlgorithmStep):
    """Blockwise quantize / restore, the dtype preserved."""

    step_index = 5

    def execute(self, array):
        a = self._tensor(array)
        m = self._config.quantization
        d = self._config.dct_size
        real = a.real.dtype if a.is_complex() else a.dtype
        if m.name == "none":
            return _round_preserving_complex(a)
        if m.name == "discard":
            keep = np.arange(d) < m.keep
            mask = self._tiled((keep[:, None] & keep[None, :]).astype(
                np.float64), a.shape).to(real)
            return _real_op(_round_preserving_complex(a),
                            lambda x: x * mask)
        if m.name == "divide":
            # A true division by a tensor (CUDA divides by a host scalar as
            # a reciprocal multiply, 1 ULP off).
            div = torch.full(a.shape, float(m.divisor), dtype=real,
                             device=a.device)
            return _round_preserving_complex(_real_op(a, lambda x: x / div))
        if m.name == "qtable":
            inv_q = self._tiled(1.0 / Q.JPEG_QTABLE, a.shape).to(real)
            return _round_preserving_complex(_real_op(a, lambda x: x * inv_q))
        raise ValueError(m.name)

    def invert(self, array):
        a = self._tensor(array)
        m = self._config.quantization
        if m.name in ("none", "discard"):
            return a
        if m.name == "divide":
            dv = m.divisor
            if float(dv) == int(dv) and (
                    self._parity() or int(dv) <= (2 ** 31 - 1) // Q.MAX_AMP):
                return a * int(dv)
            ftype = torch.float64 if self._parity() else torch.float32
            prod = torch.trunc(a.to(ftype) * float(dv))
            return prod.to(a.dtype) if self._parity() else prod
        if m.name == "qtable":
            q = self._tiled(Q.JPEG_QTABLE.astype(np.int64), a.shape)
            return a * q.to(a.dtype)
        raise ValueError(m.name)


class ZigzagOrder(AlgorithmStep):
    """(H, W) coefficient plane -> (NV, NH, d*d) zigzag tensor, one
    gather."""

    step_index = 6

    def _perm(self, perm: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(perm.astype(np.int64)).to(self._device)

    def execute(self, array):
        d = self._config.dct_size
        blk = _blockify(self._tensor(array), d)
        nv, nh = blk.shape[:2]
        return blk.reshape(nv, nh, d * d).index_select(
            -1, self._perm(T.zigzag_permutation(d)))

    def invert(self, array):
        d = self._config.dct_size
        a = self._tensor(array)
        nv, nh = a.shape[:2]
        flat = a.index_select(-1, self._perm(T.inverse_zigzag_permutation(d)))
        return B.deblockify(flat.reshape(nv, nh, d, d))


class RunLengthEncoding(AlgorithmStep):
    """Zigzag tensor -> flat list of (run, size, amplitude) tuples with EOB
    markers; a host-side view."""

    step_index = 7

    def execute(self, array):
        arr = (array.cpu().numpy() if isinstance(array, torch.Tensor)
               else np.asarray(array))
        nv, nh, L = arr.shape
        return TU.encode_levels_to_tuples(arr.reshape(nv * nh, L))

    def invert(self, tuples_list):
        cfg = self._config
        nv, nh = cfg.blocks_high, cfg.blocks_wide
        levels = TU.decode_tuples_to_levels(tuples_list, nv * nh,
                                            cfg.dct_size ** 2)
        return torch.from_numpy(levels.reshape(
            nv, nh, cfg.dct_size ** 2)).to(self._device)


class RleBytestream(AlgorithmStep):
    """Tuple list <-> byte-aligned bitstream."""

    step_index = 8

    def execute(self, tuples_list):
        return TU.tuples_to_bytes(tuples_list)

    def invert(self, bytestream):
        return TU.bytes_to_tuples(bytes(bytestream))


def compress_band_steps(a, config: Configuration, device="cuda",
                        dtype=None) -> bytes:
    """Run every step's ``execute`` in ascending index order."""
    for cls in step_classes:
        a = cls(config, device, dtype).execute(a)
    return a


def decompress_band_steps(bytestream: bytes, config: Configuration,
                          device="cuda", dtype=None) -> np.ndarray:
    """Run every step's ``invert`` in descending index order; returns the
    (H, W) plane as a NumPy array."""
    a = bytestream
    for cls in reversed(step_classes):
        a = cls(config, device, dtype).invert(a)
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
