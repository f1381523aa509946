"""Pixel-domain array ops: edge padding, mean-pool subsampling, blockify.

Counterpart of ``jpeg_tpu/ops/blocks.py``.  Every function works on the
last two axes, so a leading band batch passes through.  Edge replication
is an index gather, so it takes tensors of any dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import padded_size


def pad_edge_hw(a: torch.Tensor, factor: int) -> torch.Tensor:
    """Pad the last two axes up to a multiple of ``factor`` by repeating
    the last row and column."""
    h, w = a.shape[-2:]
    H, W = padded_size(h, factor), padded_size(w, factor)
    if (H, W) == (h, w):
        return a
    rows = torch.arange(H, device=a.device).clamp(max=h - 1)
    cols = torch.arange(W, device=a.device).clamp(max=w - 1)
    return a.index_select(-2, rows).index_select(-1, cols)


def pad_edge(a: torch.Tensor, factor: int) -> torch.Tensor:
    """:func:`pad_edge_hw` (the JAX package's 2-D name)."""
    return pad_edge_hw(a, factor)


def crop(a: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Inverse of edge padding given the target dims (a view)."""
    return a[..., :height, :width]


def subsample(a: torch.Tensor, block_size: int) -> torch.Tensor:
    """Mean-pool of a float64 tensor over ``block_size`` x ``block_size``
    tiles: the sum, then one true division, so the result is bitwise the
    reference's ``np.mean``.  The integer pixel sums are exact in f64.  The
    divisor is a full tensor on purpose: CUDA divides by a host scalar as a
    reciprocal multiply, 1 ULP off for block areas that are not powers of
    two, which flips round() at the DCT's half-integer coefficients."""
    bs = block_size
    a = pad_edge_hw(a, bs)
    h, w = a.shape[-2:]
    total = a.reshape(*a.shape[:-2], h // bs, bs, w // bs, bs).sum(dim=(-3, -1))
    return total / torch.full_like(total, bs * bs)


def subsample_fast_hw(a: torch.Tensor, block_size: int) -> torch.Tensor:
    """f32 mean-pool with a fixed evaluation order: edge padding to a
    multiple of ``block_size``, left-associated strided adds over rows,
    then over columns, then a multiply by ``float32(1.0/(bs*bs))``.  This
    pins the f32 result to the JAX package's ``subsample_fast_hw`` bit for
    bit."""
    bs = block_size
    x = pad_edge_hw(a.to(torch.float32), bs)
    rows = x[..., 0::bs, :]
    for bi in range(1, bs):
        rows = rows + x[..., bi::bs, :]
    acc = rows[..., :, 0::bs]
    for bj in range(1, bs):
        acc = acc + rows[..., :, bj::bs]
    return acc * torch.tensor(np.float32(1.0 / (bs * bs)))


def subsample_fast(a: torch.Tensor, block_size: int) -> torch.Tensor:
    """:func:`subsample_fast_hw` (the JAX package's 2-D name)."""
    return subsample_fast_hw(a, block_size)


def inflate(a: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour upsample of the last two axes; inverse of
    :func:`subsample`."""
    return a.repeat_interleave(factor, dim=-2).repeat_interleave(factor,
                                                                 dim=-1)


def blockify(a: torch.Tensor, block_size: int) -> torch.Tensor:
    """(..., H, W) -> (..., H//b, W//b, b, b), padding the edge first where
    H or W is not a multiple of b."""
    b = block_size
    a = pad_edge_hw(a, b)
    *lead, h, w = a.shape
    return a.reshape(*lead, h // b, b, w // b, b).transpose(-3, -2)


def deblockify(blocks: torch.Tensor) -> torch.Tensor:
    """(..., NV, NH, b, b) -> (..., NV*b, NH*b), contiguous."""
    *lead, nv, nh, b, b2 = blocks.shape
    if b != b2:
        raise ValueError(f"blocks must be square, got {b}x{b2}")
    return blocks.transpose(-3, -2).reshape(*lead, nv * b, nh * b)
