"""Device meshes for the codec's two parallel axes.

Counterpart of ``jpeg_tpu/parallel/mesh.py``.  The codec scales along two
axes:

* ``data``: a batch of images (they are independent);
* ``band``: row-bands of one image (DCT blocks never couple across block
  rows, so whole block rows split without any halo).

torch has no ``Mesh`` or ``NamedSharding``: :class:`Mesh` is a
``(data, band)`` array of ``torch.device``, and the sharding helpers
return the per-device index map of a shape, ``{mesh position: tuple of
slices}``, the value of JAX's ``NamedSharding.devices_indices_map(shape)``
for the same mesh and spec.  ``parallel.sharded`` splits its work with
them.  A device may appear more than once (``[torch.device("cpu")] * 8``,
or one GPU repeated): its positions then run one after another on it, with
the same stitch.
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device

DATA_AXIS = "data"
BAND_AXIS = "band"

IndexMap = Dict[Tuple[int, ...], Tuple[slice, ...]]


class Mesh:
    """A ``(data, band)`` grid of devices: ``devices`` is a numpy object
    array of ``torch.device``, ``axis_names`` names its axes."""

    def __init__(self, devices: np.ndarray, axis_names=(DATA_AXIS, BAND_AXIS)):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {list(map(str, self.devices.flat))})"


def factorize(n: int, max_band: int = 8) -> Tuple[int, int]:
    """Split ``n`` devices into (data, band) axis sizes.

    Prefers the largest power-of-two band axis <= ``max_band`` that divides
    ``n``; the rest goes to the data axis.
    """
    if n < 1:
        raise ValueError(f"need at least one device, got {n}")
    band = 1
    for cand in (8, 4, 2):
        if cand <= max_band and n % cand == 0:
            band = cand
            break
    return n // band, band


def _cuda_devices() -> list:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh() takes every CUDA device but "
            "torch.cuda.is_available() is False; pass devices= (for "
            "example [torch.device('cpu')] * 8) for the plain versions")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              data: Optional[int] = None,
              band: Optional[int] = None) -> Mesh:
    """Build a ``(data, band)`` mesh over the first ``n_devices`` devices
    (default: every CUDA device; without a GPU and without ``devices`` this
    raises: there is no move to the CPU)."""
    if devices is None:
        devices = _cuda_devices()
    devices = [resolve_device(d) for d in devices]
    if n_devices is None:
        if data is not None and band is not None:
            n_devices = data * band
        else:
            n_devices = len(devices)
    if len(devices) < n_devices:
        raise ValueError(
            f"requested {n_devices} devices but only {len(devices)} available")
    devices = devices[:n_devices]
    n = len(devices)
    if data is None and band is None:
        data, band = factorize(n)
    elif data is None:
        if n % band:
            raise ValueError(f"band={band} does not divide {n} devices")
        data = n // band
    elif band is None:
        if n % data:
            raise ValueError(f"data={data} does not divide {n} devices")
        band = n // data
    if data * band != len(devices):
        raise ValueError(
            f"mesh {data}x{band} does not match {len(devices)} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(data, band))


def fit_spec(shape: Sequence[int], mesh: Mesh, spec: Sequence) -> tuple:
    """Drop partition entries whose axis size doesn't divide the dimension.

    As in the JAX package, a dimension that does not divide evenly stays
    whole on every device (replicated): correct, but that dimension's work
    is then done once instead of split, so it warns (once per call site by
    Python's default warning filter).
    """
    sizes = mesh.shape
    fitted = []
    for dim, name in zip(shape, tuple(spec) + (None,) * len(shape)):
        if name is not None and dim % sizes[name] == 0:
            fitted.append(name)
        else:
            if name is not None and sizes[name] > 1:
                warnings.warn(
                    f"dimension of size {dim} is not divisible by mesh axis "
                    f"{name!r} ({sizes[name]} devices); leaving it "
                    f"unsharded — pad the batch/rows for full parallelism",
                    stacklevel=3)
            fitted.append(None)
    return tuple(fitted)


def _index_map(mesh: Mesh, shape: Sequence[int], spec: Sequence) -> IndexMap:
    """``{mesh position: slices}`` of ``shape`` under ``spec`` (fitted):
    a dimension named by an axis of n > 1 devices splits into n equal
    contiguous parts in the axis' order; every other dimension is whole
    (``slice(None)``, as JAX writes it)."""
    spec = fit_spec(shape, mesh, spec)
    sizes = mesh.shape
    out: IndexMap = {}
    for pos in np.ndindex(mesh.devices.shape):
        coord = dict(zip(mesh.axis_names, pos))
        idx = []
        for dim, name in zip(shape, spec):
            if name is None or sizes[name] == 1:
                idx.append(slice(None))
            else:
                step = dim // sizes[name]
                idx.append(slice(coord[name] * step,
                                 (coord[name] + 1) * step))
        out[pos] = tuple(idx)
    return out


def batch_sharding(mesh: Mesh, shape: Sequence[int]) -> IndexMap:
    """(B, H, W) image-band batches: batch over data, rows over band."""
    return _index_map(mesh, shape, (DATA_AXIS, BAND_AXIS, None))


def levels_sharding(mesh: Mesh, shape: Sequence[int]) -> IndexMap:
    """(B, num_blocks, L) levels: block axis follows the row-band axis."""
    return _index_map(mesh, shape, (DATA_AXIS, BAND_AXIS, None))


def plane_sharding(mesh: Mesh, shape: Sequence[int]) -> IndexMap:
    """(H, W) single plane: rows over the flattened device axis (position
    k of the flattened mesh is ``np.unravel_index(k, devices.shape)``)."""
    flat = Mesh(mesh.devices.reshape(-1), (BAND_AXIS,))
    return {tuple(int(i) for i in np.unravel_index(k, mesh.devices.shape)):
            idx for (k,), idx in _index_map(flat, shape,
                                        (BAND_AXIS, None)).items()}


def replicated(mesh: Mesh, shape: Sequence[int]) -> IndexMap:
    """Every device holds the whole array."""
    return _index_map(mesh, shape, ())
