"""Device selection and the f32 precision the codec needs."""
from __future__ import annotations

import contextlib

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """The ``device`` argument of the public API as a ``torch.device``.

    ``"cuda"`` (the default everywhere) runs the hand-written kernels and
    raises when no GPU is present: there is no silent move to the CPU.
    ``"cpu"`` runs every kernel's plain PyTorch version.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but "
                "torch.cuda.is_available() is False; pass device='cpu' for "
                "the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


_FLOAT_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def resolve_dtype(dtype) -> torch.dtype:
    """The ``dtype`` argument of the public API: ``None`` or float32 for
    the f32 path, float64 for the f64 parity mode (bit parity with the
    reference; its transforms loop over blocks on the host, so it is for
    small images).  Each may be a torch dtype, or anything ``np.dtype``
    reads as one (``np.float64``, ``"float64"``), as the reference takes."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    else:
        try:
            name = np.dtype(dtype).name
        except TypeError:
            name = None
    if name not in _FLOAT_DTYPES:
        raise ValueError(f"dtype must be None, float32 or float64 (a torch "
                         f"or numpy dtype or its name), got {dtype!r}")
    return _FLOAT_DTYPES[name]


def caller_stream(dev: torch.device):
    """A context-manager factory that makes the calling thread's current
    CUDA stream current in another thread.

    Threads start on the device's default stream, so a worker that pulls
    the results of kernels launched on the caller's stream enters this
    first: its copies then wait for those kernels."""
    if dev.type != "cuda":
        return contextlib.nullcontext
    stream = torch.cuda.current_stream(dev)
    return lambda: torch.cuda.stream(stream)


# The settings that govern float32 matrix products: cuBLAS on the GPU and
# oneDNN on the CPU (where "medium" precision means bf16).  The codec runs no
# convolution, so cuDNN's settings do not bear on it and are left alone.
_F32_MATMUL_BACKENDS = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)


@contextlib.contextmanager
def full_f32_matmul():
    """Run the enclosed float32 matrix products in full f32.

    TF32 keeps about three decimal digits, and coefficients reach 255*d*d:
    reduced-precision products move quantized levels by several units, far
    outside the +-1-at-ties contract (``utils/parity.py``).  The codec wraps
    each of its f32 products in this and checks that the setting took.

    It sets each backend's ``fp32_precision`` to ``"ieee"`` and restores the
    caller's values on exit, so the surrounding program's own products keep
    the precision it chose.  It touches only these per-backend settings
    (torch 2.9 and later): the legacy switches (``allow_tf32``,
    ``set_float32_matmul_precision``) also write a global that the per-backend
    ones do not restore.
    """
    saved = [b.fp32_precision for b in _F32_MATMUL_BACKENDS]
    try:
        for b in _F32_MATMUL_BACKENDS:
            b.fp32_precision = "ieee"
        if any(b.fp32_precision != "ieee" for b in _F32_MATMUL_BACKENDS):
            raise RuntimeError("could not disable TF32 for float32 products")
        yield
    finally:
        for b, value in zip(_F32_MATMUL_BACKENDS, saved):
            b.fp32_precision = value
