"""Per-band coefficient pipeline: pixels <-> quantized zigzag levels.

Counterpart of ``jpeg_tpu/ops/band.py`` as two ``nn.Module``s, built per
call for a :class:`~jpeg_tpu_torch.config.Configuration`, a working dtype
and a device.  They hold the operators and quantizer vectors as buffers
(the codec's "weights", made in f64 by ``ops/transform.py`` /
``ops/quantize.py``), taken from one cache of the process that keeps each
buffer cast and on its device:

* **Key.** Exactly what the tensor is a function of: an operator by its
  function of ``ops/transform.py`` and that function's arguments (``d``,
  the effective block size, the transform), a quantizer vector by the
  quantizer's ``to_json()`` and ``d``; then the tensor's dtype and its
  ``torch.device``.  The branch is not cached: each module still picks it
  from its configuration (a share's from the whole image's), then takes
  the buffers that branch needs, so frames of every size at one setting
  share one operator.
* **Bound.** ``_CACHE_BYTES`` a device, least recently used out first;
  the newest entry is always kept.
* **Threads.** One lock guards the entries and a second serialises the
  builds, so threads that miss together make one entry.  A module whose
  buffers were all there counts ``band.cache_hits``; one that built any
  counts ``band.builds``, and the building is the span ``band.build``.
* **Streams.** A miss builds on the caller's current CUDA stream and
  synchronises it before the entry is visible, so no hit reads before
  the upload has landed.  A hit from another stream marks the tensors
  used there (``record_stream``), so an evicted entry's memory is not
  reused while that stream's kernels may still read it.
* **No in-place writes.** A cached tensor is shared by every module of
  its key: no code may write one in place (``copy_``, ``load_state_dict``
  and the like).  ``.to(...)`` makes new tensors and keeps working.

:class:`BandEncoder` takes ``make_encode``'s branches, chosen in its order
(``branch`` names the one in use):

* ``separable`` (DCT, divisible geometry, f32): subsample + DCT as two
  chained single-axis contractions with the separable factor, the static
  zigzag take and the quantizer epilogue.
* ``sep_pad`` (DCT, padded geometry, f32): the pinned-order f32 subsample,
  edge padding to the DCT size, then the same two contractions with the
  bs = 1 factor.
* ``combined`` (DFT, divisible, f32): one joint product with the combined
  subsample + DFT + zigzag operator over each (d*bs)^2 pixel block.
* ``blocks`` (DFT, padded, f32): subsample, edge padding, blockify, then
  kernel K5 (``ops/kernels.py:encode_blocks``) with the DFT operator.
* ``parity`` (f64): the f64 subsample (sum, then a true division), edge
  padding, blockify, the reference-order host transform
  (``transform.exact_*``) and the f64 quantizer.

As in the JAX package, where the first three are plain XLA dots outside any
Pallas kernel, their products are plain ``torch.matmul`` in full f32.

:class:`BandDecoder` takes ``make_decode``'s:

* ``kernel`` (f32, an integer dequantizer; any geometry, DCT or DFT): K4
  (``ops/kernels.py:decode_blocks``) applies dequantize, the d*d x d*d
  dezigzag + inverse transform operator (the ``chain`` branch's cache
  entry), round and clamp in one pass, and writes each pixel to its
  bs x bs places (counted ``band.inflate_store`` where bs > 1); the
  blocks are laid out as the plane and cropped.
* ``combined`` (f32, no integer dequantizer, divisible): the truncating
  (or wrap-guarded f32) dequantize, then the same combined operator as one
  ``torch.matmul``, round and clamp.
* ``chain`` (f32, no integer dequantizer, padded): dequantize, the plain
  inverse transform, round and clamp, crop to the subsampled size, inflate,
  crop to the image.
* ``parity`` (f64): the ``chain`` with the int64 / f64 dequantize and the
  reference-order host inverse transform.

f64 runs its transforms on the host in the reference's order whatever the
device, as the JAX package does through ``pure_callback``; everything else
about it is elementwise torch on the module's device.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..config import Configuration
from ..utils.device import full_f32_matmul, resolve_device, resolve_dtype
from ..utils.profiling import count, span
from . import blocks as B
from . import kernels as K
from . import quantize as Q
from . import transform as T


def _divisible(config: Configuration) -> bool:
    """No edge padding anywhere: the combined operators apply."""
    h, w, bs, d = (config.height, config.width, config.block_size,
                   config.dct_size)
    return (h % bs == 0 and w % bs == 0
            and (h // bs) % d == 0 and (w // bs) % d == 0)


def _encode_branch(config: Configuration, dtype: torch.dtype) -> str:
    if dtype == torch.float64:
        return "parity"
    if config.transform == "DCT":
        return "separable" if _divisible(config) else "sep_pad"
    return "combined" if _divisible(config) else "blocks"


def _decode_branch(config: Configuration, dtype: torch.dtype, deq) -> str:
    if dtype == torch.float64:
        return "parity"
    if deq is not None:
        return "kernel"
    return "combined" if _divisible(config) else "chain"


def _check_transform(config: Configuration) -> None:
    if config.transform not in ("DCT", "DFT"):
        raise ValueError(f"unknown transform {config.transform!r}")


def check_band_shape(band_shape, config: Configuration) -> None:
    """The encoder derives geometry from the array while the header stores
    config dims; a mismatch would silently write a corrupt container."""
    from ..config import BadArrayShapeError
    if tuple(band_shape) != (config.height, config.width):
        raise BadArrayShapeError(
            f"band shape {tuple(band_shape)} != configured "
            f"(height, width) = {(config.height, config.width)}")


def _tensor(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float64)).to(dtype).contiguous()


#: Bytes of cached buffers kept a device: a dozen of the largest operators,
#: the ``combined`` branch's at d 24 (9,216 x 576 in f32 at bs 4, 21 MB
#: each), beside the small ones (the ``kernel`` branch's d 24 operator is
#: 576 x 576, 1.3 MB).
_CACHE_BYTES = 256 << 20


class _Entry(NamedTuple):
    tensor: torch.Tensor
    device: torch.device
    stream: Optional[torch.cuda.Stream]   # the CUDA stream that made it


class _BufferCache:
    """The band modules' buffers, cast and on their devices (see the
    module's docstring).  Keys end with the device."""

    def __init__(self) -> None:
        self._lock = threading.Lock()          # the entries
        self._build_lock = threading.Lock()    # one build at a time
        self._entries: OrderedDict = OrderedDict()

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def _hit(self, key, stream) -> Optional[torch.Tensor]:
        e = self._entries.get(key)
        if e is None:
            return None
        self._entries.move_to_end(key)
        if stream is not None and stream != e.stream:
            e.tensor.record_stream(stream)
        return e.tensor

    def _put(self, key, tensor, device, stream) -> None:
        self._entries[key] = _Entry(tensor, device, stream)
        mine = [k for k, e in self._entries.items() if e.device == device]
        held = sum(self._entries[k].tensor.nbytes for k in mine)
        for k in mine[:-1]:                    # oldest first; keep the newest
            if held <= _CACHE_BYTES:
                break
            held -= self._entries.pop(k).tensor.nbytes

    def fetch(self, device: torch.device, wants):
        """``wants``: (key, make) pairs, ``make()`` the tensor on the host.
        Returns each key's tensor on ``device`` and whether any was built."""
        stream = (torch.cuda.current_stream(device)
                  if device.type == "cuda" else None)
        keys = [(*key, device) for key, _ in wants]
        with self._lock:
            got = [self._hit(k, stream) for k in keys]
        if all(t is not None for t in got):
            return got, False
        with self._build_lock:
            with self._lock:                   # built by another thread?
                got = [self._hit(k, stream) for k in keys]
            missing = [i for i, t in enumerate(got) if t is None]
            if missing:
                with span("band.build"):
                    for i in missing:
                        got[i] = wants[i][1]().to(device)
                    if stream is not None:
                        stream.synchronize()
                with self._lock:
                    for i in missing:
                        self._put(keys[i], got[i], device, stream)
        return got, bool(missing)


_CACHE = _BufferCache()


def _operator(fn, *args):
    """The cache's key and build of ``fn(*args)``, an operator of
    ``ops/transform.py``, transposed and cast to f32."""
    return ((fn, *args, torch.float32),
            lambda: _tensor(fn(*args).T, torch.float32))


def _epilogue(method, d: int, dtype: torch.dtype) -> dict:
    """The cache's keys and builds of the quantizer's (mul, div, mask)."""
    q = method.to_json()
    return {name: ((Q.epilogue_vectors, name, q, d, dtype),
                   lambda i=i: _tensor(Q.epilogue_vectors(method, d)[i],
                                       dtype))
            for i, name in enumerate(("mul", "div", "mask"))}


class _BandModule(nn.Module):
    """What the two band modules share: their buffers come from the cache
    on ``device`` (the CPU by default), counting one ``band.cache_hits``
    where all were there, else one ``band.builds``."""

    def _take(self, wants: dict, device) -> None:
        """Register the buffers ``wants`` names (name -> (key, make))."""
        got, built = _CACHE.fetch(
            resolve_device("cpu" if device is None else device),
            list(wants.values()))
        count("band.builds" if built else "band.cache_hits")
        for name, t in zip(wants, got):
            self.register_buffer(name, t)


class BandEncoder(_BandModule):
    """(B, H, W) bands (any real dtype) -> (B, num_blocks, L) int32 levels.

    ``device``: where its buffers are, from the cache (the CPU by default).
    ``_image`` (private, for ``parallel/sharded.py``): the configuration of
    the whole image when ``config`` is a share of its block rows.  The
    branch is the whole image's, so a share computes the same per-block
    sums as the serial encode of those rows."""

    def __init__(self, config: Configuration, dtype=None, *, device=None,
                 _image: Optional[Configuration] = None):
        super().__init__()
        _check_transform(config)
        self.dtype = resolve_dtype(dtype)
        d, bs = config.dct_size, config.block_size
        self.branch = _encode_branch(
            config if _image is None else _image, self.dtype)
        self.config = config
        self.d, self.bs, self.L = d, bs, d * d
        wants = {}
        if self.branch in ("separable", "sep_pad"):
            wants["fac_t"] = _operator(                             # (D2, d)
                T.separable_encode_factor, d,
                bs if self.branch == "separable" else 1)
            wants["zigzag"] = ((T.zigzag_permutation, d, torch.int64),
                               lambda: torch.tensor(
                                   T.zigzag_permutation(d).astype(np.int64)))
        elif self.branch == "combined":
            wants["op_t"] = _operator(                              # (D*D, L)
                T.combined_encode_operator, d, bs, "DFT")
        elif self.branch == "blocks":
            wants["op_t"] = _operator(T.dft_encode_operator, d)     # (L, L)
        wants.update(_epilogue(config.quantization, d, self.dtype))
        self._take(wants, device)

    def _sep2(self, x: torch.Tensor) -> torch.Tensor:
        """Separable DCT + zigzag of f32 planes whose last two dims are
        multiples of the factor's width: stage 1 contracts the pixel rows
        of each stripe (-> row frequency r), stage 2 the pixel columns of
        each block (-> column frequency c)."""
        D2, d = self.fac_t.shape
        w = x.shape[-1]
        x = x.reshape(-1, D2, w)                            # (B*NV, D2, W)
        with full_f32_matmul():
            t1 = torch.matmul(x.transpose(1, 2), self.fac_t)  # (B*NV, W, r)
            t1 = t1.reshape(-1, w // D2, D2, d)            # (B*NV, NH, j, r)
            t2 = torch.matmul(t1.transpose(2, 3), self.fac_t)  # (.., r, c)
        return t2.reshape(-1, self.L).index_select(1, self.zigzag)

    def forward(self, bands: torch.Tensor) -> torch.Tensor:
        check_band_shape(bands.shape[-2:], self.config)
        nb = bands.shape[0]
        d, bs, L = self.d, self.bs, self.L
        if self.branch == "separable":
            coeffs = self._sep2(bands.to(torch.float32))
        elif self.branch == "sep_pad":
            sub = B.pad_edge_hw(B.subsample_fast_hw(bands, bs), d)
            coeffs = self._sep2(sub)
        elif self.branch == "combined":
            D = d * bs
            h, w = bands.shape[-2:]
            x = (bands.to(torch.float32)
                 .reshape(nb, h // D, D, w // D, D).transpose(2, 3)
                 .reshape(-1, D * D))
            with full_f32_matmul():
                coeffs = torch.matmul(x, self.op_t)
        elif self.branch == "blocks":
            sub = B.subsample_fast_hw(bands, bs)
            vecs = B.blockify(sub, d).reshape(-1, L).contiguous()
            levels = K.encode_blocks(vecs, self.op_t, self.mul, self.div,
                                     self.mask)
            return levels.reshape(nb, -1, L)
        else:
            sub = B.subsample(bands.to(torch.float64), bs)
            blk = B.blockify(sub, d).reshape(-1, d, d).cpu().numpy()
            exact = (T.exact_dct2_zigzag if self.config.transform == "DCT"
                     else T.exact_dft2_real_zigzag)
            coeffs = torch.from_numpy(exact(blk, d)).to(bands.device)
        levels = Q.epilogue(coeffs, self.mul, self.div, self.mask)
        return levels.to(torch.int32).reshape(nb, -1, L)


class BandDecoder(_BandModule):
    """(B, num_blocks, L) int32 levels -> (B, H, W) uint8 planes.

    ``device``, ``_image``: as :class:`BandEncoder`'s (``_image`` gives a
    share of the block rows the whole image's branch)."""

    def __init__(self, config: Configuration, dtype=None, *, device=None,
                 _image: Optional[Configuration] = None):
        super().__init__()
        _check_transform(config)
        self.dtype = resolve_dtype(dtype)
        d, bs = config.dct_size, config.block_size
        deq = Q.dequant_int_vector(config.quantization, d)
        self.branch = _decode_branch(
            config if _image is None else _image, self.dtype, deq)
        self.config = config
        self.d, self.bs, self.D, self.L = d, bs, d * bs, d * d
        wants = {}
        if self.branch == "combined":
            wants["op_t"] = _operator(T.combined_decode_operator, d, bs,
                                      config.transform)
        elif self.branch in ("kernel", "chain"):
            wants["op_t"] = _operator(
                T.decode_operator if config.transform == "DCT"
                else T.dft_decode_operator, d)
        if self.branch == "kernel":
            q = config.quantization.to_json()
            wants["deq"] = ((Q.dequant_int_vector, q, d, torch.int32),
                            lambda: torch.tensor(deq.astype(np.int32)))
        self._take(wants, device)

    def forward(self, levels: torch.Tensor) -> torch.Tensor:
        cfg, d, D, L = self.config, self.d, self.D, self.L
        nb = levels.shape[0]
        if tuple(levels.shape[1:]) != (cfg.num_blocks, L):
            raise ValueError(f"levels shape {tuple(levels.shape)} != "
                             f"(B, {cfg.num_blocks}, {L})")
        nv, nh = cfg.blocks_high, cfg.blocks_wide
        if self.branch == "kernel":
            flat = levels.reshape(-1, L).to(torch.int32).contiguous()
            if self.bs > 1:
                count("band.inflate_store")
            pix = K.decode_blocks(flat, self.op_t, self.deq,   # (B*N, D*D)
                                  bs=self.bs)
            plane = B.deblockify(pix.reshape(nb, nv, nh, D, D))
            return B.crop(plane, cfg.height, cfg.width).contiguous()
        method = cfg.quantization
        if self.branch == "parity":
            deq = Q.dequantize(levels.to(torch.int64), method, d,
                               parity=True).to(torch.float64)
            host = deq.reshape(-1, L).cpu().numpy()
            exact = (T.exact_izigzag_idct2 if cfg.transform == "DCT"
                     else T.exact_izigzag_idft2_real)
            blk = torch.from_numpy(exact(host, d)).to(levels.device)
        else:
            deq = Q.dequantize(levels.to(torch.int32), method, d)
            with full_f32_matmul():
                blk = torch.matmul(deq.to(torch.float32), self.op_t)
            if self.branch == "combined":
                pix = blk.round().clamp(0, 255).to(torch.uint8)
                return B.deblockify(pix.reshape(nb, nv, nh, D, D))
        plane = B.deblockify(blk.reshape(nb, nv, nh, d, d))
        # Round first, then clamp (the reference's BasisChange.invert, then
        # Normalization.invert); then crop the DCT padding, inflate and
        # crop the block-size padding.
        plane = plane.round().clamp(0, 255).to(torch.uint8)
        plane = B.crop(plane, cfg.subsampled_height, cfg.subsampled_width)
        return B.crop(B.inflate(plane, self.bs), cfg.height,
                      cfg.width).contiguous()
