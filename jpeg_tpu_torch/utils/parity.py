"""f32 cross-path parity contract: equal except +-1 at provable round ties.

The f32 path evaluates the same linear maps through several evaluation
orders — XLA's and cuBLAS's blocked matmuls, the TPU kernels' packed
panels, the port's 3xTF32 tensor-core product (csrc/tc_product.cuh), the
separable two-stage contraction (ops/band.py) — and ``round()`` sits right
after each.  Where the EXACT (f64) pre-round value is an exact half-integer
(the unnormalized DCT's cos(pi/4) rows and the DFT's dyadic-rational
operator entries make these common), the computed f32 value lands an ULP
above or below the tie depending on accumulation order, and the rounded
integers legitimately differ by 1.

So the honest cross-path contract, asserted by :func:`assert_tie_equal`:

    two f32 paths agree bitwise, EXCEPT at positions where the f64
    pre-round value lies within the f32 accumulation error bound of an
    exact .5 tie — there they may differ by exactly 1.

This module is the same pure-NumPy contract as ``jpeg_tpu/utils/parity.py``.
The f64 parity mode (``dtype=torch.float64``) is exempt from it: it
reproduces the reference bitwise through the reference-order host
transforms (``ops/transform.py`` ``exact_*``).  It provides the f64
references and tie masks for both directions and both transforms, so the
port can be held to the contract on the GPU, where ``jpeg_tpu`` cannot be
imported.

Scope note: a non-integer ``divide`` divisor restores by ``trunc``, a
boundary this mask does not model.  The f64 reference truncates the f64
product; the f32 decode truncates ``f32(level) * f32(divisor)``.  The two
agree where that f32 product is exact (a divisor such as 2.5), and there
the contract holds; for other divisors (2.3) compare with another f32 path
instead.
"""
from __future__ import annotations

import numpy as np

from ..config import Configuration, padded_size
from ..ops import quantize as Q
from ..ops import transform as T

EPS32 = 2.0 ** -23


def _pad_edge_np(a: np.ndarray, f: int) -> np.ndarray:
    H = padded_size(a.shape[0], f)
    W = padded_size(a.shape[1], f)
    if (H, W) == a.shape:
        return a
    return np.pad(a, ((0, H - a.shape[0]), (0, W - a.shape[1])), mode="edge")


def _dequant_np(levels, method, d: int) -> np.ndarray:
    """f64 dequantized coefficients (int-exact; mirrors ops/quantize.py)."""
    lv = np.asarray(levels, np.int64)
    name = method.name
    if name in ("none", "discard"):
        return lv.astype(np.float64)
    if name == "divide":
        dv = method.divisor
        if float(dv) == int(dv):
            return (lv * int(dv)).astype(np.float64)
        return np.trunc(lv.astype(np.float64) * float(dv))
    if name == "qtable":
        return (lv * Q.qtable_zigzag(d).astype(np.int64)).astype(np.float64)
    raise ValueError(name)


def encode_reference_and_ties(cfg: Configuration, band):
    """f64-reference levels and the encode tie mask, shapes (N, L).

    Returns ``(levels_ref int32, ties bool)``: ``ties[i, j]`` marks a
    quantized value whose f64 pre-round magnitude sits within the f32
    error bound of an exact .5 tie — the only positions where f32
    evaluation orders may differ (by exactly 1).
    """
    bs, d = cfg.block_size, cfg.dct_size
    L = d * d
    a = np.asarray(band, np.float64)
    if bs > 1:
        a = _pad_edge_np(a, bs)
        a = a.reshape(a.shape[0] // bs, bs, a.shape[1] // bs, bs) \
             .mean(axis=(1, 3))
    a = _pad_edge_np(a, d)
    nv, nh = a.shape[0] // d, a.shape[1] // d
    vec = a.reshape(nv, d, nh, d).transpose(0, 2, 1, 3).reshape(nv * nh, L)
    enc = (T.encode_operator(d) if cfg.transform == "DCT"
           else T.dft_encode_operator(d))
    return blocks_reference_and_ties(
        vec, enc, *Q.epilogue_vectors(cfg.quantization, d))


def blocks_reference_and_ties(vec, enc, mul, div, mask):
    """:func:`encode_reference_and_ties` for (N, L) pixel blocks ``vec``
    already subsampled and padded, the (L, L) operator ``enc`` and the
    quantizer's epilogue vectors: the contract of the block product
    ``round((vec @ enc.T) * mul / div) * mask`` (kernel K5's)."""
    L = enc.shape[0]
    vec = np.asarray(vec, np.float64)
    q = (vec @ enc.T) * mul / div
    levels_ref = (np.round(q) * mask).astype(np.int32)
    # |computed_f32 - exact| <= ~(contraction length) * eps * sum|terms|;
    # the factored abs (|vec| @ |enc|.T) upper-bounds every evaluation
    # order in use (joint dot, packed block-diagonal panels, separable
    # two-stage chain — see module docstring); +16 covers the subsample
    # division (bs^2 not a power of two) and the quantizer epilogue ULPs.
    absq = (np.abs(vec) @ np.abs(enc.T)) * np.abs(mul) / div
    bound = (L + 16) * EPS32 * absq
    frac = np.abs(q - np.floor(q) - 0.5)
    ties = (frac <= bound) & (mask != 0)
    return levels_ref, ties


def decode_reference_and_ties(cfg: Configuration, levels):
    """f64-reference plane and the decode tie mask, shapes (H, W).

    Returns ``(plane_ref int32, ties bool)`` for the full
    levels -> dequant -> IDCT/IDFT -> round -> clamp -> inflate -> crop
    chain (reference decompress_band order: basis_change.py:43 rounds,
    normalization.py:10-14 clamps, subsampling.py:13-14 inflates).
    """
    bs, d = cfg.block_size, cfg.dct_size
    D = d * bs
    nv, nh = cfg.blocks_high, cfg.blocks_wide
    deq = _dequant_np(levels, cfg.quantization, d)       # (N, L) f64
    dec2 = T.combined_decode_operator(d, bs, cfg.transform)  # (D*D, L)
    pix = deq @ dec2.T                                   # (N, D*D)
    absv = np.abs(deq) @ np.abs(dec2.T)

    def assemble(x):
        return x.reshape(nv, nh, D, D).transpose(0, 2, 1, 3) \
                .reshape(nv * D, nh * D)[:cfg.height, :cfg.width]

    v = assemble(pix)
    bound = (d * d + 16) * EPS32 * assemble(absv)
    plane_ref = np.clip(np.round(v), 0, 255).astype(np.int32)
    frac = np.abs(v - np.floor(v) - 0.5)
    return plane_ref, frac <= bound


def tie_diff_report(got, want, ties):
    """None if ``got`` satisfies the tie contract against ``want``, else a
    human-readable violation string.  Contract: elementwise equal, except
    positions flagged in ``ties`` may differ by exactly 1."""
    got = np.asarray(got)
    want = np.asarray(want)
    if got.shape != want.shape:
        return f"shape mismatch: {got.shape} vs {want.shape}"
    diff = got != want
    if not diff.any():
        return None
    bad = diff & ~np.asarray(ties)
    if bad.any():
        idx = tuple(i[0] for i in np.nonzero(bad))
        return (f"{bad.sum()} non-tie mismatches, first at {idx}: "
                f"{got[idx]} vs {want[idx]} (tie-flagged: {ties[idx]})")
    step = np.abs(got.astype(np.int64) - want.astype(np.int64))
    if (m := step[diff].max()) > 1:
        idx = tuple(i[0] for i in np.nonzero(diff & (step > 1)))
        return f"tie position differs by {m} > 1 at {idx}"
    return None


def assert_tie_equal(got, want, ties, label=""):
    """Assert the +-1-at-provable-ties contract (see module docstring)."""
    msg = tie_diff_report(got, want, ties)
    if msg is not None:
        raise AssertionError(f"tie contract violated {label}: {msg}")
