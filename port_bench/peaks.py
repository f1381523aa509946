"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit) and the least time a piece of work needs.

Copied from chip_smoke.py's ``bound()`` and its constants, so that the
yardstick stays fixed whatever happens to that script.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12


def bound(nbytes: float, flops: float = 0.0, rate: float = F32_FLOP_PER_S):
    """(seconds, side): the least time the card could take to move
    ``nbytes`` (each input read once, each output written once) and do
    ``flops`` operations at ``rate`` per second, and which of the two sets
    it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / rate
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
