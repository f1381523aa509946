"""Pixel-domain array ops on the last two axes (batch-polymorphic)."""
from __future__ import annotations

import torch


def crop(a: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Inverse of edge padding given the target dims (a view)."""
    return a[..., :height, :width]


def deblockify(blocks: torch.Tensor) -> torch.Tensor:
    """(..., NV, NH, b, b) -> (..., NV*b, NH*b), contiguous."""
    *lead, nv, nh, b, b2 = blocks.shape
    if b != b2:
        raise ValueError(f"blocks must be square, got {b}x{b2}")
    return blocks.transpose(-3, -2).reshape(*lead, nv * b, nh * b)
