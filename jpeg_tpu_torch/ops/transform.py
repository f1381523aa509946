"""Block-transform operators: unnormalized DCT-II fused with zigzag.

The numpy (float64) operator builders of ``jpeg_tpu/ops/transform.py`` that
the main path uses, with the same arithmetic so the operators compare
bitwise.  They are the codec's "weights": built once per configuration in
f64 and cast to f32 where a module stores them as buffers
(``ops/band.py``).

The DCT matrix is the reference's *unnormalized* DCT-II,
``A[k, n] = cos(pi/N * (n + 0.5) * k)``; the inverse is ``A.T @ D^-2`` with
``D = diag(row norms)``.
"""
from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """Unnormalized DCT-II matrix (float64)."""
    k = np.arange(n, dtype=np.float64)[:, None]
    m = np.arange(n, dtype=np.float64)[None, :]
    return np.cos(np.pi / n * (m + 0.5) * k)


@functools.lru_cache(maxsize=None)
def idct_matrix(n: int) -> np.ndarray:
    """Inverse of :func:`dct_matrix`: ``A_norm.T @ D^-1``."""
    a = dct_matrix(n)
    norms = np.linalg.norm(a, axis=1)
    a_norm = a / norms[:, None]
    return a_norm.T @ np.diag(1.0 / norms)


@functools.lru_cache(maxsize=None)
def zigzag_permutation(n: int) -> np.ndarray:
    """Flat (row-major) block indices in zigzag scan order, shape (n*n,).

    Diagonal walk: up-diagonals from the top-left rows, then from the
    bottom-right columns, with every odd diagonal reversed.
    """
    diags = []
    for r in range(n):
        diags.append([(r - t, t) for t in range(r + 1)])
    for c in range(1, n):
        diags.append([(n - 1 - t, c + t) for t in range(n - c)])
    order = []
    for k, d in enumerate(diags):
        if k % 2 == 1:
            d = d[::-1]
        order.extend(i * n + j for i, j in d)
    return np.asarray(order, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def encode_operator(n: int) -> np.ndarray:
    """(d*d, d*d) matrix ``M`` with ``coeffs_zz = M @ vec(block)``: row ``p``
    is row ``zz[p]`` of ``A kron A`` (DCT + zigzag in one matmul)."""
    a = dct_matrix(n)
    m2 = np.kron(a, a)
    return m2[zigzag_permutation(n), :]


@functools.lru_cache(maxsize=None)
def decode_operator(n: int) -> np.ndarray:
    """(d*d, d*d) matrix ``W`` with ``vec(block) = W @ coeffs_zz``: column
    ``p`` is column ``zz[p]`` of ``B kron B`` (dezigzag + IDCT fused)."""
    b = idct_matrix(n)
    w2 = np.kron(b, b)
    return w2[:, zigzag_permutation(n)]


@functools.lru_cache(maxsize=None)
def separable_encode_factor(d: int, bs: int) -> np.ndarray:
    """(d, d*bs) separable factor ``F`` of the combined subsample + DCT
    encode map: the 2-D mean-pool factors as ``S kron S`` and the 2-D DCT as
    ``A kron A``, so ``(A@S) kron (A@S)`` is the whole pixel -> coefficient
    map and zigzag is a static permutation of the (r, c) row-major result.
    Two chained single-axis contractions with this factor are the encode
    (``ops/band.py:BandEncoder``)."""
    D = d * bs
    sub = np.zeros((d, D), dtype=np.float64)
    for p in range(d):
        sub[p, p * bs:(p + 1) * bs] = 1.0 / bs
    return dct_matrix(d) @ sub


@functools.lru_cache(maxsize=None)
def combined_decode_operator(d: int, bs: int,
                             transform: str = "DCT") -> np.ndarray:
    """((d*bs)^2, d*d) operator fusing dezigzag + IDCT with the
    nearest-neighbour inflate: ``vec(pixel_block) = OP2 @ coeffs_zz`` where
    the pixel block is the (d*bs) x (d*bs) region one d x d transform block
    inflates to.

    Replica rows are identical rows of the plain decode operator, so each
    replica's f32 dot product is bitwise equal and rounding after the
    product equals round-then-inflate.  This slice ports the DCT operator
    only; DFT is queued in ROADMAP.md.
    """
    if transform != "DCT":
        raise NotImplementedError(
            f"transform {transform!r}: only DCT is ported (ROADMAP Queue 1)")
    D = d * bs
    rep = np.zeros((D * D, d * d), dtype=np.float64)
    for p in range(d):
        for q in range(d):
            for i in range(bs):
                for j in range(bs):
                    rep[(p * bs + i) * D + (q * bs + j), p * d + q] = 1.0
    return rep @ decode_operator(d)
