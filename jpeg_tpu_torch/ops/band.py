"""Per-band coefficient pipeline: pixels <-> quantized zigzag levels.

Counterpart of ``jpeg_tpu/ops/band.py`` as two ``nn.Module``s built per
:class:`~jpeg_tpu_torch.config.Configuration` and working dtype.  They hold
the operators and quantizer vectors as buffers (the codec's "weights",
built in f64 by ``ops/transform.py`` / ``ops/quantize.py`` and cast to the
working dtype once), so ``.to(device)`` moves a whole codec configuration.

:class:`BandEncoder` takes ``make_encode``'s branches, chosen in its order
(``branch`` names the one in use):

* ``separable`` (DCT, divisible geometry, f32): subsample + DCT as two
  chained single-axis contractions with the separable factor, the static
  zigzag take and the quantizer epilogue.
* ``sep_pad`` (DCT, padded geometry, f32): the pinned-order f32 subsample,
  edge padding to the DCT size, then the same two contractions with the
  bs = 1 factor.
* ``combined`` (DFT, divisible, f32): one joint product with the combined
  subsample + DFT + zigzag operator over each (d*bs)^2 pixel block.
* ``blocks`` (DFT, padded, f32): subsample, edge padding, blockify, then
  kernel K5 (``ops/kernels.py:encode_blocks``) with the DFT operator.
* ``parity`` (f64): the f64 subsample (sum, then a true division), edge
  padding, blockify, the reference-order host transform
  (``transform.exact_*``) and the f64 quantizer.

As in the JAX package, where the first three are plain XLA dots outside any
Pallas kernel, their products are plain ``torch.matmul`` in full f32.

:class:`BandDecoder` takes ``make_decode``'s:

* ``kernel`` (f32, an integer dequantizer; any geometry, DCT or DFT): K4
  (``ops/kernels.py:decode_blocks``) applies dequantize, the combined
  dezigzag + inverse transform + inflate operator, round and clamp in one
  pass; the blocks are laid out as the plane and cropped.
* ``combined`` (f32, no integer dequantizer, divisible): the truncating
  (or wrap-guarded f32) dequantize, then the same combined operator as one
  ``torch.matmul``, round and clamp.
* ``chain`` (f32, no integer dequantizer, padded): dequantize, the plain
  inverse transform, round and clamp, crop to the subsampled size, inflate,
  crop to the image.
* ``parity`` (f64): the ``chain`` with the int64 / f64 dequantize and the
  reference-order host inverse transform.

f64 runs its transforms on the host in the reference's order whatever the
device, as the JAX package does through ``pure_callback``; everything else
about it is elementwise torch on the module's device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..config import Configuration
from ..utils.device import full_f32_matmul, resolve_dtype
from ..utils.profiling import count, span
from . import blocks as B
from . import kernels as K
from . import quantize as Q
from . import transform as T


def _divisible(config: Configuration) -> bool:
    """No edge padding anywhere: the combined operators apply."""
    h, w, bs, d = (config.height, config.width, config.block_size,
                   config.dct_size)
    return (h % bs == 0 and w % bs == 0
            and (h // bs) % d == 0 and (w // bs) % d == 0)


def _encode_branch(config: Configuration, dtype: torch.dtype) -> str:
    if dtype == torch.float64:
        return "parity"
    if config.transform == "DCT":
        return "separable" if _divisible(config) else "sep_pad"
    return "combined" if _divisible(config) else "blocks"


def _decode_branch(config: Configuration, dtype: torch.dtype, deq) -> str:
    if dtype == torch.float64:
        return "parity"
    if deq is not None:
        return "kernel"
    return "combined" if _divisible(config) else "chain"


def _check_transform(config: Configuration) -> None:
    if config.transform not in ("DCT", "DFT"):
        raise ValueError(f"unknown transform {config.transform!r}")


def check_band_shape(band_shape, config: Configuration) -> None:
    """The encoder derives geometry from the array while the header stores
    config dims; a mismatch would silently write a corrupt container."""
    from ..config import BadArrayShapeError
    if tuple(band_shape) != (config.height, config.width):
        raise BadArrayShapeError(
            f"band shape {tuple(band_shape)} != configured "
            f"(height, width) = {(config.height, config.width)}")


def _tensor(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float64)).to(dtype).contiguous()


class _BandModule(nn.Module):
    """What the two band modules share: their build (operators looked up
    and cast, buffers registered) is the span ``band.build`` and counts
    one ``band.builds``; the move of their buffers by ``.to`` is the span
    ``band.to_device``."""

    def to(self, *args, **kwargs):
        with span("band.to_device"):
            return super().to(*args, **kwargs)


class BandEncoder(_BandModule):
    """(B, H, W) bands (any real dtype) -> (B, num_blocks, L) int32 levels.

    ``_image`` (private, for ``parallel/sharded.py``): the configuration of
    the whole image when ``config`` is a share of its block rows.  The
    branch is the whole image's, so a share computes the same per-block
    sums as the serial encode of those rows."""

    def __init__(self, config: Configuration, dtype=None, *,
                 _image: Optional[Configuration] = None):
        count("band.builds")
        with span("band.build"):
            super().__init__()
            _check_transform(config)
            self.dtype = resolve_dtype(dtype)
            d, bs = config.dct_size, config.block_size
            self.branch = _encode_branch(
                config if _image is None else _image, self.dtype)
            self.config = config
            self.d, self.bs, self.L = d, bs, d * d
            if self.branch in ("separable", "sep_pad"):
                fac = T.separable_encode_factor(
                    d, bs if self.branch == "separable" else 1)     # (d, D2)
                self.register_buffer("fac_t", _tensor(fac.T, torch.float32))
                self.register_buffer("zigzag", torch.tensor(
                    T.zigzag_permutation(d).astype(np.int64)))
            elif self.branch == "combined":
                op = T.combined_encode_operator(d, bs, "DFT")       # (L, D*D)
                self.register_buffer("op_t", _tensor(op.T, torch.float32))
            elif self.branch == "blocks":
                self.register_buffer("op_t", _tensor(
                    T.dft_encode_operator(d).T, torch.float32))     # (L, L)
            mul, div, mask = Q.epilogue_vectors(config.quantization, d)
            self.register_buffer("mul", _tensor(mul, self.dtype))
            self.register_buffer("div", _tensor(div, self.dtype))
            self.register_buffer("mask", _tensor(mask, self.dtype))

    def _sep2(self, x: torch.Tensor) -> torch.Tensor:
        """Separable DCT + zigzag of f32 planes whose last two dims are
        multiples of the factor's width: stage 1 contracts the pixel rows
        of each stripe (-> row frequency r), stage 2 the pixel columns of
        each block (-> column frequency c)."""
        D2, d = self.fac_t.shape
        w = x.shape[-1]
        x = x.reshape(-1, D2, w)                            # (B*NV, D2, W)
        with full_f32_matmul():
            t1 = torch.matmul(x.transpose(1, 2), self.fac_t)  # (B*NV, W, r)
            t1 = t1.reshape(-1, w // D2, D2, d)            # (B*NV, NH, j, r)
            t2 = torch.matmul(t1.transpose(2, 3), self.fac_t)  # (.., r, c)
        return t2.reshape(-1, self.L).index_select(1, self.zigzag)

    def forward(self, bands: torch.Tensor) -> torch.Tensor:
        check_band_shape(bands.shape[-2:], self.config)
        nb = bands.shape[0]
        d, bs, L = self.d, self.bs, self.L
        if self.branch == "separable":
            coeffs = self._sep2(bands.to(torch.float32))
        elif self.branch == "sep_pad":
            sub = B.pad_edge_hw(B.subsample_fast_hw(bands, bs), d)
            coeffs = self._sep2(sub)
        elif self.branch == "combined":
            D = d * bs
            h, w = bands.shape[-2:]
            x = (bands.to(torch.float32)
                 .reshape(nb, h // D, D, w // D, D).transpose(2, 3)
                 .reshape(-1, D * D))
            with full_f32_matmul():
                coeffs = torch.matmul(x, self.op_t)
        elif self.branch == "blocks":
            sub = B.subsample_fast_hw(bands, bs)
            vecs = B.blockify(sub, d).reshape(-1, L).contiguous()
            levels = K.encode_blocks(vecs, self.op_t, self.mul, self.div,
                                     self.mask)
            return levels.reshape(nb, -1, L)
        else:
            sub = B.subsample(bands.to(torch.float64), bs)
            blk = B.blockify(sub, d).reshape(-1, d, d).cpu().numpy()
            exact = (T.exact_dct2_zigzag if self.config.transform == "DCT"
                     else T.exact_dft2_real_zigzag)
            coeffs = torch.from_numpy(exact(blk, d)).to(bands.device)
        levels = Q.epilogue(coeffs, self.mul, self.div, self.mask)
        return levels.to(torch.int32).reshape(nb, -1, L)


class BandDecoder(_BandModule):
    """(B, num_blocks, L) int32 levels -> (B, H, W) uint8 planes.

    ``_image``: as :class:`BandEncoder`'s, the whole image's branch for a
    share of its block rows."""

    def __init__(self, config: Configuration, dtype=None, *,
                 _image: Optional[Configuration] = None):
        count("band.builds")
        with span("band.build"):
            super().__init__()
            _check_transform(config)
            self.dtype = resolve_dtype(dtype)
            d, bs = config.dct_size, config.block_size
            deq = Q.dequant_int_vector(config.quantization, d)
            self.branch = _decode_branch(
                config if _image is None else _image, self.dtype, deq)
            self.config = config
            self.d, self.bs, self.D, self.L = d, bs, d * bs, d * d
            if self.branch in ("kernel", "combined"):
                op = T.combined_decode_operator(d, bs, config.transform)
                self.register_buffer("op_t", _tensor(op.T, torch.float32))
            elif self.branch == "chain":
                op = (T.decode_operator(d) if config.transform == "DCT"
                      else T.dft_decode_operator(d))
                self.register_buffer("op_t", _tensor(op.T, torch.float32))
            if self.branch == "kernel":
                self.register_buffer("deq", torch.tensor(deq.astype(np.int32)))

    def forward(self, levels: torch.Tensor) -> torch.Tensor:
        cfg, d, D, L = self.config, self.d, self.D, self.L
        nb = levels.shape[0]
        if tuple(levels.shape[1:]) != (cfg.num_blocks, L):
            raise ValueError(f"levels shape {tuple(levels.shape)} != "
                             f"(B, {cfg.num_blocks}, {L})")
        nv, nh = cfg.blocks_high, cfg.blocks_wide
        if self.branch == "kernel":
            flat = levels.reshape(-1, L).to(torch.int32).contiguous()
            pix = K.decode_blocks(flat, self.op_t, self.deq)   # (B*N, D*D)
            plane = B.deblockify(pix.reshape(nb, nv, nh, D, D))
            return B.crop(plane, cfg.height, cfg.width).contiguous()
        method = cfg.quantization
        if self.branch == "parity":
            deq = Q.dequantize(levels.to(torch.int64), method, d,
                               parity=True).to(torch.float64)
            host = deq.reshape(-1, L).cpu().numpy()
            exact = (T.exact_izigzag_idct2 if cfg.transform == "DCT"
                     else T.exact_izigzag_idft2_real)
            blk = torch.from_numpy(exact(host, d)).to(levels.device)
        else:
            deq = Q.dequantize(levels.to(torch.int32), method, d)
            with full_f32_matmul():
                blk = torch.matmul(deq.to(torch.float32), self.op_t)
            if self.branch == "combined":
                pix = blk.round().clamp(0, 255).to(torch.uint8)
                return B.deblockify(pix.reshape(nb, nv, nh, D, D))
        plane = B.deblockify(blk.reshape(nb, nv, nh, d, d))
        # Round first, then clamp (the reference's BasisChange.invert, then
        # Normalization.invert); then crop the DCT padding, inflate and
        # crop the block-size padding.
        plane = plane.round().clamp(0, 255).to(torch.uint8)
        plane = B.crop(plane, cfg.subsampled_height, cfg.subsampled_width)
        return B.crop(B.inflate(plane, self.bs), cfg.height,
                      cfg.width).contiguous()
