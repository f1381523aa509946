"""ctypes bindings for the host C++ entropy codec (built lazily with g++).

The C++ source is the port's own ``native/entropy.cpp``, a byte-for-byte
copy of the JAX package's ``jpeg_tpu/entropy/native/entropy.cpp`` (a test
holds the two equal), so the port neither imports nor reads anything of
``jpeg_tpu``.  The shared object goes into the repository's
``build/native/`` directory, keyed by the source hash, so a rebuilt source
never reuses a stale library.

This is the host side of the codec (the serial boundary scan
``jt_scan_offsets`` on decode, and the reference encoder the device stream
is checked against), not a GPU kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from typing import Optional

import numpy as np

from ..config import BadRleCodeError, BadStreamError

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(os.path.dirname(_HERE))
_SRC = os.path.join(_HERE, "native", "entropy.cpp")
_BUILD_DIR = os.path.join(_REPO, "build", "native")
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    return os.path.join(_BUILD_DIR, f"entropy_{digest}.so")


def _build() -> Optional[ctypes.CDLL]:
    global _build_error
    try:
        so = _so_path()
    except OSError as e:
        _build_error = str(e)
        return None
    if not os.path.exists(so):
        # Per-process temp name + atomic rename: test workers may build
        # concurrently.
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
               "-fno-exceptions", "-o", tmp, _SRC]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
            os.replace(tmp, so)
        except (subprocess.CalledProcessError, OSError) as e:
            _build_error = getattr(e, "stderr", str(e)) or str(e)
            print(f"jpeg_tpu_torch: native entropy codec build failed; "
                  f"falling back to NumPy codec:\n{_build_error}",
                  file=sys.stderr)
            return None
    lib = ctypes.CDLL(so)
    lib.jt_encode.restype = ctypes.c_int64
    lib.jt_encode.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                              ctypes.c_void_p, ctypes.c_int64]
    lib.jt_encode_bound.restype = ctypes.c_int64
    lib.jt_encode_bound.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.jt_decode.restype = ctypes.c_int64
    lib.jt_decode.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                              ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
    lib.jt_scan_offsets.restype = ctypes.c_int64
    lib.jt_scan_offsets.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_int64]
    return lib


def available() -> bool:
    global _lib
    if _lib is None and _build_error is None:
        _lib = _build()
    return _lib is not None


def _require() -> ctypes.CDLL:
    if not available():
        raise RuntimeError(f"native entropy codec unavailable: {_build_error}")
    return _lib


def encode_levels(levels: np.ndarray) -> bytes:
    lib = _require()
    levels = np.ascontiguousarray(levels, dtype=np.int32)
    n, L = levels.shape
    cap = int(lib.jt_encode_bound(n, L))
    out = np.empty(cap, dtype=np.uint8)
    res = lib.jt_encode(levels.ctypes.data, n, L, out.ctypes.data, cap)
    if res == -2:
        raise BadRleCodeError(
            f"amplitude exceeds {1 << 14} - 1 (size > 15)")
    if res < 0:
        raise RuntimeError(f"native encode failed with code {res}")
    return out[:res].tobytes()


def _raise_stream_error(res: int, buf_size: int, num_blocks: int) -> None:
    if res == -3:
        raise BadRleCodeError("invalid code: nonzero run with size 0")
    if res == -4:
        raise BadStreamError("coefficient index overflows block")
    if res == -5:
        raise BadStreamError("truncated stream")
    if res == -6:
        raise BadStreamError("block did not terminate with EOB")
    if res < 0:
        raise RuntimeError(f"native codec failed with code {res}")
    if res != buf_size:
        raise BadStreamError(
            f"stream has {buf_size - res} trailing bytes after "
            f"{num_blocks} blocks")


def scan_offsets(data: bytes, num_blocks: int, L: int) -> np.ndarray:
    """Validate the stream and return each block's start byte offset.

    The serial O(bytes) part of decode; everything per-coefficient then runs
    block-parallel on the device (``device_codec.decode_stream``)."""
    lib = _require()
    buf = np.frombuffer(data, dtype=np.uint8)     # no copy of a view
    starts = np.zeros(num_blocks, dtype=np.int32)
    res = lib.jt_scan_offsets(buf.ctypes.data if buf.size else None,
                              buf.size, starts.ctypes.data, num_blocks, L)
    _raise_stream_error(res, buf.size, num_blocks)
    return starts


def decode_levels(data: bytes, num_blocks: int, L: int) -> np.ndarray:
    lib = _require()
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    out = np.zeros((num_blocks, L), dtype=np.int32)
    res = lib.jt_decode(buf.ctypes.data if buf.size else None, buf.size,
                        out.ctypes.data, num_blocks, L)
    _raise_stream_error(res, buf.size, num_blocks)
    return out
