"""Per-band coefficient pipeline: pixels <-> quantized zigzag levels.

Counterpart of ``jpeg_tpu/ops/band.py`` for the main path, as two
``nn.Module``s built per :class:`~jpeg_tpu_torch.config.Configuration`.
They hold the operators and quantizer vectors as buffers (the codec's
"weights", built in f64 by ``ops/transform.py`` / ``ops/quantize.py`` and
cast to f32 once), so ``.to(device)`` moves a whole codec configuration.

* :class:`BandEncoder` — the ``separable`` branch of ``make_encode``
  (divisible geometry, DCT): subsample + DCT as two chained single-axis
  f32 contractions with the separable factor, the static zigzag take, and
  the quantizer epilogue (``ops/quantize.py:epilogue``).  As in the JAX
  package, where the two contractions are plain XLA dots outside any
  Pallas kernel, they are plain ``torch.matmul`` in full f32.
* :class:`BandDecoder` — the ``use_pallas`` / ``combined_p`` branch of
  ``make_decode``: kernel K4 (``ops/kernels.py:decode_blocks``) applies
  dequantize, the combined dezigzag + IDCT + inflate operator, round and
  clamp in one pass; the blocks are then laid out as the plane and cropped.

Padded geometry on encode, the DFT transform and the f64 parity mode are
later items of ROADMAP.md Queue 1 and raise NotImplementedError here.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..config import Configuration
from ..utils.device import full_f32_matmul
from . import blocks as B
from . import kernels as K
from . import quantize as Q
from . import transform as T


def _divisible(config: Configuration) -> bool:
    """No edge padding anywhere: the separable encode applies."""
    h, w, bs, d = (config.height, config.width, config.block_size,
                   config.dct_size)
    return (h % bs == 0 and w % bs == 0
            and (h // bs) % d == 0 and (w // bs) % d == 0)


def _require_dct(config: Configuration) -> None:
    if config.transform != "DCT":
        raise NotImplementedError(
            f"transform {config.transform!r}: only DCT is ported "
            "(ROADMAP.md Queue 1)")


def check_band_shape(band_shape, config: Configuration) -> None:
    """The encoder derives geometry from the array while the header stores
    config dims; a mismatch would silently write a corrupt container."""
    from ..config import BadArrayShapeError
    if tuple(band_shape) != (config.height, config.width):
        raise BadArrayShapeError(
            f"band shape {tuple(band_shape)} != configured "
            f"(height, width) = {(config.height, config.width)}")


def _f32(a: np.ndarray) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


class BandEncoder(nn.Module):
    """(B, H, W) bands (any real dtype) -> (B, num_blocks, L) int32 levels."""

    def __init__(self, config: Configuration):
        super().__init__()
        _require_dct(config)
        if not _divisible(config):
            raise NotImplementedError(
                f"{config.height}x{config.width} at block_size "
                f"{config.block_size}, dct_size {config.dct_size} needs edge "
                "padding: the padded encode is ROADMAP.md Queue 1 item 7")
        d, bs = config.dct_size, config.block_size
        self.config = config
        self.d, self.D2, self.L = d, d * bs, d * d
        fac = T.separable_encode_factor(d, bs)                 # (d, D2)
        self.register_buffer("fac_t", _f32(fac.T).contiguous())  # (D2, d)
        self.register_buffer("zigzag", torch.tensor(
            T.zigzag_permutation(d).astype(np.int64)))
        mul, div, mask = Q.epilogue_vectors(config.quantization, d)
        self.register_buffer("mul", _f32(mul))
        self.register_buffer("div", _f32(div))
        self.register_buffer("mask", _f32(mask))

    def forward(self, bands: torch.Tensor) -> torch.Tensor:
        check_band_shape(bands.shape[-2:], self.config)
        nb, w = bands.shape[0], bands.shape[-1]
        D2, d, L = self.D2, self.d, self.L
        x = bands.to(torch.float32).reshape(-1, D2, w)     # (B*NV, D2, W)
        # stage 1 contracts the D2 pixel rows of each stripe (-> row freq r),
        # stage 2 the D2 pixel columns of each block (-> column freq c)
        with full_f32_matmul():
            t1 = torch.matmul(x.transpose(1, 2), self.fac_t)  # (B*NV, W, r)
            t1 = t1.reshape(-1, w // D2, D2, d)            # (B*NV, NH, j, r)
            t2 = torch.matmul(t1.transpose(2, 3), self.fac_t)  # (.., r, c)
        coeffs = t2.reshape(-1, L).index_select(1, self.zigzag)
        levels = Q.epilogue(coeffs, self.mul, self.div, self.mask)
        return levels.to(torch.int32).reshape(nb, -1, L)


class BandDecoder(nn.Module):
    """(B, num_blocks, L) int32 levels -> (B, H, W) uint8 planes."""

    def __init__(self, config: Configuration):
        super().__init__()
        _require_dct(config)
        d, bs = config.dct_size, config.block_size
        deq = Q.dequant_int_vector(config.quantization, d)
        if deq is None:
            raise NotImplementedError(
                f"{config.quantization!r}: a non-integer (or int32-wrapping) "
                "divisor restores by truncation, which the decode kernel does "
                "not take (ROADMAP.md Queue 1 item 7)")
        self.config = config
        self.D, self.L = d * bs, d * d
        self.register_buffer("op_t", _f32(
            T.combined_decode_operator(d, bs).T).contiguous())  # (L, D*D)
        self.register_buffer("deq", torch.tensor(deq.astype(np.int32)))

    def forward(self, levels: torch.Tensor) -> torch.Tensor:
        cfg, D, L = self.config, self.D, self.L
        nb = levels.shape[0]
        if tuple(levels.shape[1:]) != (cfg.num_blocks, L):
            raise ValueError(f"levels shape {tuple(levels.shape)} != "
                             f"(B, {cfg.num_blocks}, {L})")
        flat = levels.reshape(-1, L).to(torch.int32).contiguous()
        pix = K.decode_blocks(flat, self.op_t, self.deq)     # (B*N, D*D)
        plane = B.deblockify(pix.reshape(nb, cfg.blocks_high, cfg.blocks_wide,
                                         D, D))
        return B.crop(plane, cfg.height, cfg.width).contiguous()
