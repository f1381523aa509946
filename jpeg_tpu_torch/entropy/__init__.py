"""Host entropy coding: run-length + bitstream pack/unpack.

Backends, as in ``jpeg_tpu.entropy``:
  * ``native``  — the C++ codec (ctypes), built lazily from
    ``jpeg_tpu/entropy/native/entropy.cpp`` (see :mod:`.native_codec`);
  * ``numpy``   — the vectorized NumPy codec; always available.

``encode_levels`` / ``decode_levels`` use the native codec, and the NumPy
one only where the C++ build fails; so does ``scan_offsets`` unless its
``scan`` policy picks the device scan (:mod:`.device_scan`).  The device
encoder and decoder live in :mod:`.device_codec`.
"""
from __future__ import annotations

import threading

import numpy as np

from ..utils.profiling import span
from . import device_scan, numpy_codec
from .numpy_codec import MAX_AMP, MAX_RUN, MAX_SIZE

_native = None
_native_checked = False
_native_lock = threading.Lock()


def _get_native():
    global _native, _native_checked
    with _native_lock:   # band threads call this concurrently
        if not _native_checked:
            _native_checked = True
            from . import native_codec
            _native = native_codec if native_codec.available() else None
    return _native


def encode_levels(levels: np.ndarray) -> bytes:
    levels = np.asarray(levels)
    if levels.dtype.kind not in "iu":
        raise TypeError(f"levels must be integer, got {levels.dtype}")
    wide = (levels.dtype.itemsize > 4
            or (levels.dtype.kind == "u" and levels.dtype.itemsize >= 4))
    # Validate BEFORE the int32 narrowing below — a wrapped value would
    # otherwise encode a valid-looking but wrong stream.  Range test, not
    # np.abs: |int64 min| overflows abs.
    if levels.size and wide and ((levels > MAX_AMP) | (levels < -MAX_AMP)).any():
        from ..config import BadRleCodeError
        raise BadRleCodeError(
            f"amplitude magnitude exceeds {MAX_AMP}: "
            f"range [{levels.min()}, {levels.max()}]")
    levels = np.ascontiguousarray(levels, dtype=np.int32)
    nat = _get_native()
    if nat is not None:
        return nat.encode_levels(levels)
    return numpy_codec.encode_levels(levels)


def decode_levels(data: bytes, num_blocks: int, L: int) -> np.ndarray:
    nat = _get_native()
    if nat is not None:
        return nat.decode_levels(data, num_blocks, L)
    return numpy_codec.decode_levels(data, num_blocks, L)


def scan_offsets(data: bytes, num_blocks: int, L: int, scan: str = "auto",
                 device="cuda") -> np.ndarray:
    """Validate a band stream and return each block's start byte offset.

    The serial O(bytes) prelude to the block-parallel device decode.  The
    host scan is the C++ scanner when available, else the pure-Python
    word-window scanner (one interpreted step per code: seconds per
    multi-megapixel image).  ``scan`` is the policy of
    :func:`.device_scan.scan_mode` (``"auto"``, ``"host"`` or ``"device"``);
    the device scan runs on ``device`` and gives the same starts and the
    same errors (:func:`.device_scan.scan_offsets_hybrid`)."""
    if device_scan.scan_mode(len(data), scan, device) == "device":
        return device_scan.scan_offsets_hybrid(data, num_blocks, L, device)
    with span("scan.host"):
        return device_scan._host_scan(data, num_blocks, L)


__all__ = ["MAX_AMP", "MAX_RUN", "MAX_SIZE", "decode_levels",
           "encode_levels", "scan_offsets"]
