"""Public codec API: band- and image-level compress/decompress on a GPU (or
the CPU).

Counterpart of ``jpeg_tpu/api.py``.  ``compress_band`` / ``decompress_band``
work on single planes with host entropy coding; :class:`Jpeg` wraps the
image functions.  ``compress_ycbcr`` / ``compress_many`` encode with device
entropy coding (the content-sized two-phase encode);
``decompress_to_ycbcr`` / ``decompress_to_device`` / ``decompress_many``
find the block boundaries with the host C++ scan or the device scan
(``scan=``; ``"auto"`` takes the device scan on a CUDA device and the host
scan on the CPU) and decode on the device; both scans give the same planes
and the same errors.  Containers are the same bytes as the JAX package's.
Positional parameters are the reference's, in its order;
``device``, ``scan`` and ``enc`` are keyword-only after them.  Every function
takes ``device``: ``"cuda"`` (the default) runs the hand-written kernels and
raises without a GPU; ``"cpu"`` runs their plain PyTorch versions.  Every
function also takes ``dtype``: ``None`` (f32, the default) or float64
(``torch.float64``, ``np.float64`` or ``"float64"``), the parity mode, which
reproduces the reference bit for bit through the reference-order host
transforms (for small images: they loop over blocks).
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from . import container, entropy
from .config import BadRleCodeError, Configuration
from .container import CompressedData
from .entropy import device_codec as DC
from .entropy import device_scan as DS
from .ops import kernels as K
from .ops.band import BandDecoder, BandEncoder
from .utils.device import caller_stream, resolve_device
from .utils.profiling import carry, count, span


def compress_band(a, config: Configuration, dtype=None, *,
                  device="cuda") -> bytes:
    """(H, W) band -> entropy-coded bytestream: the coefficient transform on
    ``device``, the entropy coding on the host."""
    dev = resolve_device(device)
    band = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    levels = BandEncoder(config, dtype, device=dev)(band[None])[0]
    return entropy.encode_levels(levels.cpu().numpy())


def decompress_band(data: bytes, config: Configuration, dtype=None, *,
                    device="cuda") -> np.ndarray:
    """Band bytestream -> (H, W) int32 reconstruction: the entropy decode on
    the host, the coefficient decode on ``device``."""
    dev = resolve_device(device)
    levels = entropy.decode_levels(bytes(data), config.num_blocks,
                                   config.dct_size ** 2)
    plane = BandDecoder(config, dtype, device=dev)(
        torch.from_numpy(levels)[None].to(dev))[0]
    return plane.cpu().numpy().astype(np.int32)


# ---------------------------------------------------------------------------
# Encode: start (phase 1 launched), advance (stats pulled, phase 2
# launched), finish (stream pulled, container packed).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Encode:
    """One image's encode in flight on the device."""
    config: Configuration
    levels: torch.Tensor            # (3N, L) int32
    stats: torch.Tensor             # (5,) int64: longest block, total,
    #                                 band 0 bytes, band 1 bytes, max |level|
    enc: str = "lv"                 # row writer: K1 ("lv") or K9 ("tables")
    band_bytes: tuple = ()          # set by _advance_compress
    stream: Optional[torch.Tensor] = None   # phase-2 buffer (advance)
    overflow: Optional[torch.Tensor] = None  # phase-2 overflow flag


def _start_compress(ycbcr: np.ndarray, config: Configuration,
                    dev: torch.device, dtype, enc: str = "lv") -> _Encode:
    """Upload the image and launch phase 1 (the coefficient transform and
    every block's stream length) without waiting for it.  An ``enc`` the
    configuration cannot take raises first."""
    DC.check_enc(enc, config.dct_size ** 2)
    ycbcr = np.asarray(ycbcr)
    if ycbcr.ndim != 3 or ycbcr.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) YCbCr array, got {ycbcr.shape}")
    img = torch.from_numpy(np.ascontiguousarray(ycbcr)).to(dev)
    levels = BandEncoder(config, dtype, device=dev)(img.permute(2, 0, 1))
    flat = levels.reshape(-1, levels.shape[-1])
    bb = DC.block_bytes_of(flat).to(torch.int64)
    band_bytes = bb.reshape(3, -1).sum(dim=-1)
    stats = torch.stack([bb.max(), bb.sum(), band_bytes[0], band_bytes[1],
                         flat.abs().max().to(torch.int64)])
    return _Encode(config, flat, stats, enc)


def _advance_compress(state: _Encode) -> _Encode:
    """Pull phase 1's stats (waits for phase 1 only), reject an
    unrepresentable amplitude BEFORE any entropy coding, and launch phase 2
    (kernels K1 or K9, then K2) at the sizes the stats give, without waiting
    for it.  Idempotent."""
    if state.stream is not None:
        return state
    max_bb, total, b0, b1, mx = (int(x) for x in state.stats.cpu())
    if mx > entropy.MAX_AMP:
        raise BadRleCodeError(
            f"amplitude {mx} exceeds the representable {entropy.MAX_AMP}")
    state.stream, _, state.overflow = DC.encode_stream_sized(
        state.levels, -(-max_bb // 4), total, state.enc)
    state.band_bytes = (b0, b1, total - b0 - b1)
    return state


def _finish_compress(state: _Encode) -> bytes:
    """Wait for phase 2, check its overflow flag and pack the container."""
    _advance_compress(state)
    DC.check_sized_ok(state.overflow.cpu())
    raw = state.stream.cpu().numpy().tobytes()
    b0, b1, b2 = state.band_bytes
    bands = [raw[:b0], raw[b0:b0 + b1], raw[b0 + b1:b0 + b1 + b2]]
    return container.generate_data(state.config, CompressedData(*bands))


def compress_ycbcr(ycbcr: np.ndarray, config: Configuration, dtype=None, *,
                   device="cuda", enc: str = "lv") -> bytes:
    """(H, W, 3) uint8 YCbCr image -> container bytes.

    All three bands (including luma) go through the same subsample path,
    matching the reference codec.  The encode runs in two phases: the
    coefficient transform and every block's stream length on ``device``,
    then one small pull of their stats (longest block, total, band lengths,
    max |level|) that rejects unrepresentable amplitudes BEFORE any entropy
    coding and sizes the rows and the buffer of phase 2 (kernels K1, K2).

    ``enc`` picks how phase 2 writes each block's row: ``"lv"`` (the
    default) from the levels in kernel K1; ``"tables"`` from unit-group
    tables built by torch ops, in kernel K9 (the JAX package's tables path;
    ``dct_size`` <= 8 only, else ``ValueError``).  The container is the
    same bytes either way."""
    return _finish_compress(_start_compress(
        ycbcr, config, resolve_device(device), dtype, enc))


def compress_many(images, config: Configuration, dtype=None,
                  depth: int = 2, *, device="cuda", enc: str = "lv") -> list:
    """Pipelined encode of an iterable of (H, W, 3) YCbCr images.

    Keeps up to ``depth`` images in flight: image i's stream is pulled and
    packed on a worker thread while the caller's thread uploads image i+1
    and launches its kernels.  Results are identical to per-image
    :func:`compress_ycbcr` with the same ``enc``."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    DC.check_enc(enc, config.dct_size ** 2)
    dev = resolve_device(device)
    on_caller_stream = caller_stream(dev)
    pending: deque = deque()     # futures of bytes, then the newest state
    out = []

    def finish(state: _Encode) -> bytes:
        with on_caller_stream():   # wait for the kernels launched here
            return _finish_compress(state)

    # One worker keeps the pulls in order.
    with ThreadPoolExecutor(max_workers=1) as puller:
        def resolve(item) -> bytes:
            if isinstance(item, _Encode):
                return _finish_compress(item)
            return item.result()

        for img in images:
            if len(pending) >= depth:
                out.append(resolve(pending.popleft()))
            state = _start_compress(img, config, dev, dtype, enc)
            if pending:
                # Advance the previous image (its stats pull and phase-2
                # launch) after launching this one's phase 1, then hand its
                # stream pull to the worker.
                prev = pending.pop()
                pending.append(puller.submit(finish,
                                             _advance_compress(prev)))
            pending.append(state)
        while pending:
            out.append(resolve(pending.popleft()))
    return out


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def decompress_to_ycbcr(bytestream: bytes, dtype=None, *, device="cuda",
                        scan: str = "auto") -> np.ndarray:
    """Container bytes -> (H, W, 3) uint8 YCbCr image.

    The block boundaries come from the host's serial boundary scan (C++,
    which also validates the stream) or, with ``scan="device"``, from the
    device scan (kernels K6, K8), whose starts stay on the device.
    ``"auto"`` takes the device scan on a CUDA device, at every size, and
    the host scan on the CPU (:func:`.entropy.device_scan.decode_scan`).
    Bit parsing, dequantize, IDCT and clamp run on ``device``.  Both scans
    give the same planes and the same errors: where the device scan's check
    fails, the host scanner runs for the stream's canonical error, and the
    decode never falls back to it silently.

    From a CUDA device the image lands in page-locked host memory: the
    answer is a view of a pinned block, which goes back to the allocator
    when the last view of it dies.  Live answers hold at most
    ``_PINNED_ANSWER_BYTES`` of such blocks; past that, an answer lands in
    pageable memory, as from the CPU (see :func:`_pull`)."""
    with span("decode", request=True):
        return _pull(_start_decompress(
            bytestream, resolve_device(device), scan, dtype)())


def decompress_to_device(bytestream: bytes, dtype=None, *, device="cuda",
                         scan: str = "auto") -> torch.Tensor:
    """Container bytes -> (3, H, W) uint8 planes as a tensor on ``device``,
    not pulled to the host: for consumers whose next stage runs on the
    device.  ``.cpu().numpy().transpose(1, 2, 0)`` gives
    :func:`decompress_to_ycbcr`'s image.  ``scan`` is as there: ``"auto"``
    takes the device scan on a CUDA device, and both scans give the same
    planes and the same errors."""
    with span("decode", request=True):
        return _start_decompress(
            bytestream, resolve_device(device), scan, dtype)()


def decompress_many(blobs, dtype=None, depth: int = 2, *, device="cuda",
                    scan: str = "auto") -> list:
    """Pipelined decode of an iterable of containers: image i's check and
    plane pull run on a worker thread while the caller's thread scans and
    launches image i+1.  Results are identical to per-image
    :func:`decompress_to_ycbcr`, and ``scan`` is as there: ``"auto"`` takes
    the device scan on a CUDA device; both scans give the same planes and
    the same errors."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    dev = resolve_device(device)
    on_caller_stream = caller_stream(dev)
    pending: deque = deque()
    out = []

    def pull(resolve) -> np.ndarray:
        with on_caller_stream():   # wait for the kernels launched here
            return _pull(resolve())

    # One worker keeps the pulls in order.
    with span("decode", request=True), \
            ThreadPoolExecutor(max_workers=1) as puller:
        for blob in blobs:
            if len(pending) >= depth:
                out.append(pending.popleft().result())
            pending.append(puller.submit(
                carry(pull), _start_decompress(blob, dev, scan, dtype)))
        while pending:
            out.append(pending.popleft().result())
    return out


#: Most page-locked memory that live answers of :func:`_pull` may hold,
#: counted by the caching host allocator's blocks (a size rounded up to a
#: power of two: a 4K frame's 24.9 MB takes 32 MiB).  A pull takes its
#: block before it tests the bound, so the allocator may hold one block
#: more than this.
_PINNED_ANSWER_BYTES = 1 << 30


class _PinnedAnswers:
    """The page-locked bytes that live answers hold.  Answers are pulled on
    the caller's thread or a ``decompress_many`` worker and die on any
    thread, so one lock guards the count."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.held = 0

    def take(self, nbytes: int) -> bool:
        """Count ``nbytes`` more if that stays within the bound."""
        with self._lock:
            if self.held + nbytes > _PINNED_ANSWER_BYTES:
                return False
            self.held += nbytes
            return True

    def give(self, nbytes: int) -> None:
        with self._lock:
            self.held -= nbytes


_PINNED = _PinnedAnswers()


def _pinned_empty(planes: torch.Tensor) -> Optional[torch.Tensor]:
    """An uninitialised page-locked uint8 block shaped like ``planes``, or
    None where they are not on a CUDA device (page-locked memory needs a
    CUDA build).  The caching host allocator hands back a block whose
    answer has died."""
    if not planes.is_cuda:
        return None
    return torch.empty(planes.shape, dtype=torch.uint8, pin_memory=True)


def _pull(planes: torch.Tensor) -> np.ndarray:
    """(3, H, W) uint8 planes -> the (H, W, 3) image on the host, a
    transposed view of a (3, H, W) array, as ``planes.cpu().numpy()
    .transpose(1, 2, 0)`` gives.

    CUDA planes are copied on the current stream into a page-locked block,
    which runs at the link's rate where a pageable copy is staged through
    CUDA's own small page-locked buffers; the stream is then synchronised.  The answer's
    ``.base`` is the ndarray over the block and its ``.base`` the pinned
    tensor.  A finalizer on that ndarray gives the block's bytes back to
    the count once the answer and every view of it have died (one on the
    tensor could fire while a view still reads its memory).  Live answers
    hold at most ``_PINNED_ANSWER_BYTES``; past that, the pull takes the
    pageable ``.cpu()`` path, as planes on the CPU do, and counts
    ``decode.pull_pageable``.  The whole pull is the span ``decode.pull``."""
    with span("decode.pull"):
        host = _pinned_empty(planes)
        if host is not None:
            # The allocator's block: the size rounded up to a power of 2.
            nbytes = 1 << max(host.nbytes - 1, 0).bit_length()
            if _PINNED.take(nbytes):
                array = host.numpy()
                weakref.finalize(array, _PINNED.give, nbytes)
                host.copy_(planes, non_blocking=True)
                if planes.is_cuda:
                    torch.cuda.current_stream(planes.device).synchronize()
                return array.transpose(1, 2, 0)
            count("decode.pull_pageable")
        return planes.cpu().numpy().transpose(1, 2, 0)


def _start_decompress(bytestream: bytes, dev: torch.device, scan: str,
                      dtype=None):
    """Parse the container and launch the decode without waiting for it.

    Returns a zero-argument resolver that gives the (3, H, W) uint8 planes
    on ``dev``, so the caller's thread is free to launch the next image
    first.  :func:`.entropy.device_scan.decode_scan` picks the boundary
    scan; a container with no blocks takes the host scan.

    The band bytes are not copied on the host.  The parse gives each
    band's offset and length in ``bytestream``
    (:func:`.container.read_band_spans`), the scans read the bands in
    place, and one copy moves the caller's bytes from the first band's
    first byte to the last band's end, the two u32 length fields between
    the bands with them, to ``dev`` (``DC.upload_stream``); the counter
    ``decode.stream_bytes`` adds the bands' bytes.

    The host scan runs on three threads and raises a stream's error here.
    The device scan (K6, then K8 from each band's first byte) launches K3
    and K4 before its check is known (K3 reads zeros past the stream, so
    garbage starts are safe); the resolver reads the check and, where it
    fails, raises what :func:`.entropy.device_scan.raise_rejected` raises.
    An ``"auto"`` that takes the device scan counts ``scan.auto_device``;
    a device scan whose K8 takes its long form (more than
    ``CHASE_DIRECT_MAX`` blocks a band) counts ``scan.chase_long``.  Every
    block is at least one byte (an EOB padded to a byte), so the device
    scan rejects a band shorter than ``num_blocks`` bytes before anything
    is sized from the header's geometry: a forged header cannot make the
    decode allocate for it."""
    with span("decode.parse"):
        config, spans = container.read_band_spans(bytestream)
        view = memoryview(bytestream)
        streams = [view[pos:pos + n] for pos, n in spans]
        base = spans[0][0]
        firsts = [pos - base for pos, _ in spans]
        ends = [first + n for first, (_, n) in zip(firsts, spans)]
    nb, L = config.num_blocks, config.dct_size ** 2
    n_bytes = sum(n for _, n in spans)
    on_device = (DS.decode_scan(n_bytes, scan, dev) == "device" and nb > 0)
    if on_device:
        if scan == "auto":
            count("scan.auto_device")
        if any(n < nb for _, n in spans):
            DS.raise_rejected(streams, nb, L)
    count("decode.stream_bytes", n_bytes)
    with span("decode.upload"):
        stream = DC.upload_stream(view[base:base + ends[-1]], dev)
    if on_device:
        if K.chase_plan(stream.shape[0] + 2, len(spans), nb).anchors:
            count("scan.chase_long")
        with span("scan.device"):
            starts, ok = DS.scan_bands_starts(stream, ends, nb, L, firsts)
    else:
        # The C++ scanner releases the GIL: one band a thread, each under
        # the caller's context so that its span's parent is this call's.
        with ThreadPoolExecutor(max_workers=3) as pool:
            scans = [f.result() for f in [
                pool.submit(carry(entropy.scan_offsets), s, nb, L,
                            scan="host")
                for s in streams]]
        parts = [sc.astype(np.int64) + first
                 for sc, first in zip(scans, firsts)]
        with span("decode.upload"):
            starts = torch.from_numpy(np.concatenate(parts)).to(dev)
        ok = None                                   # nothing to check
    planes = BandDecoder(config, dtype, device=dev)(
        DC.decode_stream(stream, starts, L).reshape(3, nb, L))

    def resolve() -> torch.Tensor:
        if ok is not None:
            with span("decode.check"):
                held = bool(ok)
            if not held:
                DS.raise_rejected(streams, nb, L)
        return planes

    return resolve


# ---------------------------------------------------------------------------
# Image level
# ---------------------------------------------------------------------------

class Jpeg:
    """Image-level codec (reference pipeline/__init__.py:98-124)."""

    def __init__(self, config: Configuration, dtype=None, *, device="cuda",
                 enc: str = "lv"):
        self.config = config
        self.device = device
        self.dtype = dtype
        self.enc = enc

    def compress(self, image) -> bytes:
        """Compress a PIL image (converted to YCbCr) or (H, W, 3) array."""
        return compress_ycbcr(_to_ycbcr_array(image), self.config,
                              device=self.device, dtype=self.dtype,
                              enc=self.enc)

    @staticmethod
    def decompress(bytestream: bytes, dtype=None, *, device="cuda",
                   scan: str = "auto"):
        """Decompress container bytes to a PIL YCbCr image (or an array if
        PIL is unavailable), through :func:`decompress_to_ycbcr`: ``scan``
        is as there (``"auto"`` takes the device scan on a CUDA device; both
        scans give the same image and the same errors)."""
        arr = decompress_to_ycbcr(bytestream, device=device, scan=scan,
                                  dtype=dtype)
        try:
            from PIL import Image
        except ImportError:
            return arr
        return Image.fromarray(arr, mode="YCbCr")


def _to_ycbcr_array(image) -> np.ndarray:
    if isinstance(image, np.ndarray):
        return image
    if image.mode != "YCbCr":
        image = image.convert("YCbCr")
    return np.asarray(image)


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    """Peak signal-to-noise ratio between two images (dB)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))
