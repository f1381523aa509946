"""Block transforms: unnormalized DCT-II and the real part of the DFT,
fused with zigzag.

The numpy (float64) operator builders of ``jpeg_tpu/ops/transform.py``,
with the same arithmetic so the operators compare bitwise.  They are the
codec's "weights": built once per configuration in f64 and cast to f32
where a module stores them as buffers (``ops/band.py``).  The f64 parity
mode's reference-order host transforms (``exact_*``), the step API's
row-major operators (``kron_*``) and the reference's ``DCT`` and
``Zigzag`` objects are here too.

The DCT matrix is the reference's *unnormalized* DCT-II,
``A[k, n] = cos(pi/N * (n + 0.5) * k)``; the inverse is ``A.T @ D^-2`` with
``D = diag(row norms)``.
"""
from __future__ import annotations

import functools

import numpy as np

from ..config import BadArrayShapeError


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
    product equals round-then-inflate.
    """
    D = d * bs
    rep = np.zeros((D * D, d * d), dtype=np.float64)
    for p in range(d):
        for q in range(d):
            for i in range(bs):
                for j in range(bs):
                    rep[(p * bs + i) * D + (q * bs + j), p * d + q] = 1.0
    dec = (decode_operator(d) if transform == "DCT"
           else dft_decode_operator(d))
    return rep @ dec


@functools.lru_cache(maxsize=None)
def inverse_zigzag_permutation(n: int) -> np.ndarray:
    zz = zigzag_permutation(n)
    inv = np.empty_like(zz)
    inv[zz] = np.arange(n * n, dtype=np.int32)
    return inv


@functools.lru_cache(maxsize=None)
def combined_encode_operator(d: int, bs: int,
                             transform: str = "DCT") -> np.ndarray:
    """(d*d, (d*bs)^2) operator fusing the mean-pool subsample with the
    transform + zigzag: ``coeffs_zz = OP2 @ vec(pixel_block)`` where the
    pixel block is the (d*bs) x (d*bs) region that subsamples to one d x d
    transform block.  Only valid when the band needs no edge padding
    (pixel-domain edge replication does not commute with mean-pooling at
    the seam)."""
    D = d * bs
    sub = np.zeros((d * d, D * D), dtype=np.float64)
    w = 1.0 / (bs * bs)
    for p in range(d):
        for q in range(d):
            for i in range(bs):
                for j in range(bs):
                    sub[p * d + q, (p * bs + i) * D + (q * bs + j)] = w
    enc = (encode_operator(d) if transform == "DCT"
           else dft_encode_operator(d))
    return enc @ sub


@functools.lru_cache(maxsize=None)
def dft_encode_operator(n: int) -> np.ndarray:
    """(d*d, d*d) real operator ``M`` with ``re(fft2)_zz = M @ vec(block)``.

    For real pixel blocks ``vec(fft2(X)) = (F kron F) vec(X)`` with the
    symmetric DFT matrix F, and the codec keeps only the real part (the
    reference casts the complex coefficients to int), so the DFT mode is the
    same fused product as the DCT's with another operator."""
    j = np.arange(n, dtype=np.float64)
    f = np.exp(-2j * np.pi * np.outer(j, j) / n)
    m2 = np.real(np.kron(f, f))
    return m2[zigzag_permutation(n), :]


@functools.lru_cache(maxsize=None)
def dft_decode_operator(n: int) -> np.ndarray:
    """(d*d, d*d) real operator ``W`` with ``vec(re(ifft2)) = W @ coeffs_zz``
    (G = conj(F)/n per axis)."""
    j = np.arange(n, dtype=np.float64)
    g = np.exp(2j * np.pi * np.outer(j, j) / n) / n
    w2 = np.real(np.kron(g, g))
    return w2[:, zigzag_permutation(n)]


@functools.lru_cache(maxsize=None)
def dct_matrix_normalized(n: int) -> np.ndarray:
    """Row-normalized DCT matrix.

    Per-row scalar norms, not an axis reduction: the two differ by 1 ULP
    (BLAS dot vs add.reduce), and this matrix is part of the bit-parity
    surface."""
    a = dct_matrix(n).copy()
    for k in range(n):
        a[k] /= np.linalg.norm(a[k])
    return a


@functools.lru_cache(maxsize=None)
def normalization_matrix(n: int) -> np.ndarray:
    """diag(1/row_norm)."""
    return np.diag(1.0 / np.linalg.norm(dct_matrix(n), axis=1))


# ---------------------------------------------------------------------------
# Parity-exact transforms (the f64 parity mode only).
#
# Rounded raw coefficients are not ULP-robust: for d=8 the k=4 DCT row is
# +-cos(pi/4), so products make coefficients that are exact half-integers,
# and which side of the .5 boundary the computed f64 value lands on depends
# on the accumulation order.  A matmul (any matmul, batched or not) cannot
# reproduce the reference's np.round results bitwise.  The parity mode
# instead evaluates the transform on the host with the reference's exact
# expression tree: per-row 1-D BLAS dots, two passes, one block at a time.
# The loops are deliberate; the f32 path never uses these.
# ---------------------------------------------------------------------------

def _ref_matrices(n: int):
    a = dct_matrix(n)
    # Row-normalized matrix: per-row scalar norms.
    a_norm = a.copy()
    for k in range(n):
        a_norm[k] = a_norm[k] / np.linalg.norm(a_norm[k])
    # Diagonal inverse-norm matrix built from the axis-norm.
    dinv = np.diag(1.0 / np.linalg.norm(a, axis=1))
    return a, a_norm.T, dinv


def _host_dct2(blocks: np.ndarray, n: int) -> np.ndarray:
    """(..., n, n) -> (..., n, n) forward DCT, reference evaluation order."""
    a, _, _ = _ref_matrices(n)
    flat = np.ascontiguousarray(blocks, dtype=np.float64).reshape(-1, n, n)
    out = np.empty_like(flat)
    for b in range(flat.shape[0]):
        m = np.zeros((n, n))
        for i in range(n):
            m[i] = a.dot(flat[b][i])          # row pass
        mt = m.T
        r = np.zeros((n, n))
        for i in range(n):
            r[i] = a.dot(mt[i])               # column pass
        out[b] = r.T
    return out.reshape(blocks.shape)


def _host_idct2(coeffs: np.ndarray, n: int) -> np.ndarray:
    """Inverse DCT, reference evaluation order."""
    _, w, dinv = _ref_matrices(n)
    flat = np.ascontiguousarray(coeffs, dtype=np.float64).reshape(-1, n, n)
    out = np.empty_like(flat)
    for b in range(flat.shape[0]):
        at = flat[b].T
        m = np.zeros((n, n))
        for i in range(n):
            m[i] = w.dot(dinv.dot(at[i]))     # column pass first
        m = m.T
        r = np.zeros((n, n))
        for i in range(n):
            r[i] = w.dot(dinv.dot(m[i]))      # then row pass
        out[b] = r
    return out.reshape(coeffs.shape)


def _host_fft2_real(blocks: np.ndarray, n: int) -> np.ndarray:
    flat = np.ascontiguousarray(blocks, dtype=np.float64).reshape(-1, n, n)
    out = np.empty_like(flat)
    for b in range(flat.shape[0]):            # per block, as the reference
        out[b] = np.fft.fft2(flat[b]).real
    return out.reshape(blocks.shape)


def _host_ifft2_real(coeffs: np.ndarray, n: int) -> np.ndarray:
    flat = np.ascontiguousarray(coeffs, dtype=np.float64).reshape(-1, n, n)
    out = np.empty_like(flat)
    for b in range(flat.shape[0]):
        out[b] = np.fft.ifft2(flat[b]).real
    return out.reshape(coeffs.shape)


def exact_dct2_zigzag(blocks: np.ndarray, n: int) -> np.ndarray:
    """Parity-mode fused DCT+zigzag: (..., d, d) blocks -> (..., d*d)."""
    coeffs = _host_dct2(blocks, n)
    flat = coeffs.reshape(coeffs.shape[:-2] + (n * n,))
    return np.take(flat, zigzag_permutation(n), axis=-1)


def exact_izigzag_idct2(coeffs_zz: np.ndarray, n: int) -> np.ndarray:
    """Parity-mode dezigzag + inverse DCT: (..., d*d) -> (..., d*d)."""
    flat = np.take(coeffs_zz, inverse_zigzag_permutation(n), axis=-1)
    blocks = flat.reshape(flat.shape[:-1] + (n, n))
    return _host_idct2(blocks, n).reshape(coeffs_zz.shape)


def exact_dft2_real_zigzag(blocks: np.ndarray, n: int) -> np.ndarray:
    """Parity-mode real(fft2) + zigzag: (..., d, d) blocks -> (..., d*d)."""
    coeffs = _host_fft2_real(blocks, n)
    flat = coeffs.reshape(coeffs.shape[:-2] + (n * n,))
    return np.take(flat, zigzag_permutation(n), axis=-1)


def exact_izigzag_idft2_real(coeffs_zz: np.ndarray, n: int) -> np.ndarray:
    """Parity-mode dezigzag + real(ifft2): (..., d*d) -> (..., d, d)."""
    flat = np.take(coeffs_zz, inverse_zigzag_permutation(n), axis=-1)
    blocks = flat.reshape(flat.shape[:-1] + (n, n))
    return _host_ifft2_real(blocks, n)


def _host_fft2_complex(blocks: np.ndarray, n: int) -> np.ndarray:
    flat = np.ascontiguousarray(blocks).reshape(-1, n, n)
    out = np.empty(flat.shape, dtype=np.complex128)
    for b in range(flat.shape[0]):
        out[b] = np.fft.fft2(flat[b])
    return out.reshape(blocks.shape)


def _host_ifft2_complex(blocks: np.ndarray, n: int) -> np.ndarray:
    flat = np.ascontiguousarray(blocks).reshape(-1, n, n)
    out = np.empty(flat.shape, dtype=np.complex128)
    for b in range(flat.shape[0]):
        out[b] = np.fft.ifft2(flat[b])
    return out.reshape(blocks.shape)


def exact_fft2_blocks(blocks: np.ndarray, n: int) -> np.ndarray:
    """Parity-mode per-block ``np.fft.fft2`` on (..., d, d), complex128."""
    return _host_fft2_complex(blocks, n)


def exact_ifft2_blocks(blocks: np.ndarray, n: int) -> np.ndarray:
    """Parity-mode per-block ``np.fft.ifft2`` on (..., d, d), complex128."""
    return _host_ifft2_complex(blocks, n)


def exact_dct2_blocks(blocks: np.ndarray, n: int) -> np.ndarray:
    """Parity-mode forward DCT on (..., d, d) blocks (no zigzag)."""
    return _host_dct2(blocks, n)


def exact_idct2_blocks(blocks: np.ndarray, n: int) -> np.ndarray:
    """Parity-mode inverse DCT on (..., d, d) blocks (no zigzag)."""
    return _host_idct2(blocks, n)


@functools.lru_cache(maxsize=None)
def kron_operator(n: int) -> np.ndarray:
    """(d*d, d*d) forward 2-D DCT operator in row-major order (no zigzag)."""
    a = dct_matrix(n)
    return np.kron(a, a)


@functools.lru_cache(maxsize=None)
def kron_inverse_operator(n: int) -> np.ndarray:
    """(d*d, d*d) inverse 2-D DCT operator in row-major order (no zigzag)."""
    b = idct_matrix(n)
    return np.kron(b, b)


class DCT:
    """The reference's DCT object: 1-D / 2-D transforms with the same
    unnormalized scale, as matrix products (NumPy, float64)."""

    def __init__(self, size: int):
        self._size = size

    def transform_1d(self, x):
        return np.asarray(dct_matrix(self._size) @ np.asarray(x))

    def transform_1d_inverse(self, x):
        return np.asarray(idct_matrix(self._size) @ np.asarray(x))

    def transform_2d(self, a):
        m = dct_matrix(self._size)
        return np.asarray(m @ np.asarray(a) @ m.T)

    def transform_2d_inverse(self, a):
        b = idct_matrix(self._size)
        return np.asarray(b @ np.asarray(a) @ b.T)


class Zigzag:
    """The reference's zigzag gather / scatter for one block."""

    def __init__(self, size: int):
        self._size = size

    def zigzag_order(self, block):
        block = np.asarray(block)
        if block.shape != (self._size, self._size):
            raise BadArrayShapeError(block.shape)
        return block.reshape(-1)[zigzag_permutation(self._size)]

    def restore(self, zigzag_vec):
        v = np.asarray(zigzag_vec)
        if v.shape != (self._size * self._size,):
            raise BadArrayShapeError(v.shape)
        return v[inverse_zigzag_permutation(self._size)]
