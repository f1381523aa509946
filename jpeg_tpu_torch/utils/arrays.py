"""The reference's array utilities, by name, for host callers.

Counterpart of ``jpeg_tpu/utils/arrays.py``: the same names and call
signatures, on NumPy arrays in and out (host helpers; the codec's own
padding and blocking are the tensor ops of ``ops/blocks.py``).
"""
from __future__ import annotations

import numpy as np

from ..config import BadArrayShapeError, EmptyArrayError, padded_size


def _check_2d(a: np.ndarray) -> None:
    if a.ndim != 2:
        raise BadArrayShapeError(a.shape)
    if a.shape[0] == 0 or a.shape[1] == 0:
        raise EmptyArrayError()


def pad_array(a, factor: int) -> np.ndarray:
    """Edge-replicate pad both dims up to a multiple of ``factor``."""
    a = np.asarray(a)
    _check_2d(a)
    ph = padded_size(a.shape[0], factor) - a.shape[0]
    pw = padded_size(a.shape[1], factor) - a.shape[1]
    if ph == 0 and pw == 0:
        return a
    return np.pad(a, ((0, ph), (0, pw)), mode="edge")


def undo_pad_array(a, padding) -> np.ndarray:
    """Remove ``(rows, cols)`` of trailing padding."""
    ph, pw = padding
    h, w = a.shape[0] - ph, a.shape[1] - pw
    return np.asarray(a)[:h, :w]


def split_into_blocks(a, block_size: int) -> np.ndarray:
    """(H, W) -> (H/b, W/b, b, b), padding first if needed."""
    a = pad_array(a, block_size)
    h, w = a.shape
    b = block_size
    return a.reshape(h // b, b, w // b, b).transpose(0, 2, 1, 3)


def extract_nth_block(blocks_column, block_size: int, n: int) -> np.ndarray:
    """n-th block of a stacked block column."""
    i = n * block_size
    return np.asarray(blocks_column)[i:i + block_size]


def block_columns(a, block_size: int):
    """Yield (column_index, stacked blocks of that column)."""
    a = np.asarray(a)
    height, width = a.shape
    a = a.reshape((height * width // block_size, block_size))
    stride = width // block_size
    for j in range(stride):
        yield j, a[j::stride]


def inflate(a, factor: int) -> np.ndarray:
    """Nearest-neighbour upsample by ``factor``."""
    return np.repeat(np.repeat(np.asarray(a), factor, axis=0), factor, axis=1)


def calculate_padding(a, factor: int):
    """(pad_rows, pad_cols) to reach multiples of ``factor``."""
    return (padded_size(a.shape[0], factor) - a.shape[0],
            padded_size(a.shape[1], factor) - a.shape[1])


def band_to_array(band) -> np.ndarray:
    """PIL band -> 2-D int64 array."""
    a = np.asarray(band)
    if a.ndim != 2:
        raise BadArrayShapeError(a.shape)
    return a.astype(np.int64)
