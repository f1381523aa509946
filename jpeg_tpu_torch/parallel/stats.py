"""Exact per-block compressed sizes, computed from the levels on their
device.

Counterpart of ``jpeg_tpu/parallel/stats.py``: the same geometry the host
codec derives (``entropy/numpy_codec.py``, from the reference's
util.py:134-229):

  per nonzero:  8 * (run // 15) zero-chain bits + 8 + size code bits,
                size = bit_length(|amp|) + 1
  per block:    + 8 EOB bits, then rounded up to a whole byte.

It shares ``entropy.device_codec._geometry`` with the device encoder, so
the estimate cannot drift from the wire format.  Uses: size metrics
without pulling the levels, and each share's stream length before the
stitch (``parallel.sharded``).
"""
from __future__ import annotations

import torch

from ..entropy.device_codec import _geometry


def block_bits(levels: torch.Tensor) -> torch.Tensor:
    """(..., L) int32 zigzag levels -> (...,) exact bit count before byte
    padding."""
    shape = levels.shape
    group_bits = _geometry(levels.reshape(-1, shape[-1]))[-1]
    return (group_bits.sum(dim=-1) + 8).reshape(shape[:-1])   # + EOB


def block_bytes(levels: torch.Tensor) -> torch.Tensor:
    """(..., L) levels -> (...,) exact byte count of each block's stream."""
    return (block_bits(levels) + 7) >> 3


def total_bytes(levels: torch.Tensor) -> torch.Tensor:
    """Total compressed payload bytes over all leading axes (0-d int64)."""
    return block_bytes(levels).sum(dtype=torch.int64)
