"""Sharded encode/decode: batch data-parallelism and row-band tiling.

Counterpart of ``jpeg_tpu/parallel/sharded.py``.  The JAX package runs
the coefficient path as one jitted program over a mesh and lets GSPMD
split it.  Here the work is cut into **shares**: each share is the block
rows ``[r0, r1)`` of every plane of the images ``[i0, i1)`` of a stack,
and runs on its own device through the port's single-device pieces
(``BandEncoder`` / ``BandDecoder`` and the device codec's kernels):

* the batch functions take their shares from the mesh's index maps
  (:func:`.mesh.batch_sharding` of the ``(images, block rows, block
  columns)`` grid: images over ``data``, block rows over ``band``; a
  dimension that does not divide stays whole, as in JAX, and a share that
  several positions hold runs once, on the first of them);
* the plane functions split one plane's block rows over the flattened
  mesh in parts of ``ceil(rows / devices)``, dropping empty parts (the
  JAX package's entropy split, ``_encode_levels_parts``).

A share starts on a block row in pixel space (``dct_size * block_size``
rows), so it is the image rows ``[r0 * D, min(r1 * D, height))`` encoded
under the configuration of that height, but on the whole image's branch
of ``BandEncoder`` / ``BandDecoder`` (``_image=``): a share above a padded
bottom edge runs ``sep_pad`` / ``blocks`` / ``chain`` as the serial call
does, and computes the same per-block sums.  Only the last share reaches
the image's bottom edge, and its edge padding is the whole image's: the
padded sizes of ``ops/blocks.py`` shift by the share's first row, a
multiple of both padding factors.  Columns are whole in every share.  So
the sharded bytes and planes equal the port's serial ones in f32 and f64.

Entropy: every block's stream is byte-aligned (reference:
rle_byte_stream.py:54-56), so the streams of a plane's shares concatenate
into exactly the serial stream: the "bitstream stitch"
(:func:`stitch_streams`).  With device entropy a share runs one phase-1
stats pull, one K1 and one K2 for all its planes, and its stream splits by
plane bytes on the host; with host entropy its levels are pulled and coded
by the C++ codec on a thread pool.  Decode scans every plane's block
boundaries on the host (C++, which also validates the stream), uploads
each share's slice of the streams once (:func:`_shard_stream_slices`) and
runs one K3 and one ``BandDecoder`` a share.

Dropped from the JAX package: the jit caches (``_BATCH_FNS``,
``_PLANE_FNS``) and ``_mesh_pallas`` (each share runs the port's kernels),
the int32 self-chunking (``_batch_stream_chunked_fn``: positions are
int64 here), the power-of-two buckets and ``JPEG_TPU_NO_PALLAS``.
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import container, entropy
from ..config import BadRleCodeError, Configuration
from ..container import CompressedData
from ..entropy import device_codec as DC
from ..ops.band import BandDecoder, BandEncoder, check_band_shape
from . import mesh as mesh_lib
from . import stats


class Share(NamedTuple):
    """One device's part of the work: block rows ``[r0, r1)`` of every
    plane of images ``[i0, i1)``."""
    device: torch.device
    i0: int
    i1: int
    r0: int
    r1: int


def _row_config(config: Configuration, r0: int,
                r1: int) -> Tuple[Configuration, int, int]:
    """The configuration of block rows ``[r0, r1)`` and their image rows
    ``[y0, y1)``."""
    D = config.dct_size * config.block_size
    y0, y1 = r0 * D, min(r1 * D, config.height)
    return dataclasses.replace(config, height=y1 - y0), y0, y1


def row_shares(mesh: mesh_lib.Mesh, config: Configuration) -> List[Share]:
    """One plane's block rows in ``ceil(rows / devices)`` parts over the
    flattened mesh; more devices than block rows leave the last ones
    without a share."""
    return _row_range_shares(mesh, 0, config.blocks_high)


def _row_range_shares(mesh: mesh_lib.Mesh, r0: int, r1: int) -> List[Share]:
    """Block rows ``[r0, r1)`` of one plane in ``ceil(rows / devices)``
    parts over the flattened mesh, empty parts dropped."""
    devices = list(mesh.devices.flat)
    per = -(-(r1 - r0) // len(devices))
    return [Share(dev, 0, 1, r0 + k * per, min(r0 + (k + 1) * per, r1))
            for k, dev in enumerate(devices) if k * per < r1 - r0]


def batch_shares(mesh: mesh_lib.Mesh, config: Configuration,
                 n_images: int) -> List[Share]:
    """The shares of :func:`.mesh.batch_sharding` over the ``(images,
    block rows, block columns)`` grid, each held once."""
    grid = (n_images, config.blocks_high, config.blocks_wide)
    shares, seen = [], set()
    for pos, (si, sr, _) in mesh_lib.batch_sharding(mesh, grid).items():
        key = si.indices(grid[0])[:2] + sr.indices(grid[1])[:2]
        if key not in seen:
            seen.add(key)
            shares.append(Share(mesh.devices[pos], *key))
    return shares


def stitch_streams(parts: Sequence[bytes]) -> bytes:
    """Concatenate per-share byte-aligned streams into the canonical
    stream."""
    return b"".join(parts)


def _check_amp(mx: int) -> None:
    if mx > entropy.MAX_AMP:
        raise BadRleCodeError(
            f"amplitude {mx} exceeds the representable {entropy.MAX_AMP}")


def _share_levels(stack: np.ndarray, config: Configuration, share: Share,
                  dtype, y_off: int = 0) -> torch.Tensor:
    """Upload a share's pixels and launch its coefficient transform on the
    whole image's branch: ``(images, rows, W, C)`` host stack whose first
    row is image row ``y_off`` -> ``(n * C, blocks, L)`` int32 levels on
    the share's device, planes in image-major order."""
    cfg, y0, y1 = _row_config(config, share.r0, share.r1)
    x = torch.from_numpy(np.ascontiguousarray(
        stack[share.i0:share.i1, y0 - y_off:y1 - y_off])).to(share.device)
    planes = x.permute(0, 3, 1, 2).reshape(-1, y1 - y0, config.width)
    return BandEncoder(cfg, dtype, device=share.device,
                       _image=config)(planes)


def _encode_shares(stack: np.ndarray, config: Configuration,
                   shares: Sequence[Share], dtype, device_entropy: bool,
                   y_off: int = 0) -> List[bytes]:
    """Encode the shares' rows of every plane of an ``(images, rows, W,
    C)`` host stack whose first row is image row ``y_off``; returns the
    ``images * C`` plane streams of those rows, image-major."""
    n_img, C = stack.shape[0], stack.shape[3]
    # Every share's transform is launched before anything is pulled.
    levels = [_share_levels(stack, config, s, dtype, y_off) for s in shares]
    if device_entropy:
        parts = _device_entropy(levels)
    else:
        parts = _host_entropy(levels)
    streams = []
    for g in range(n_img * C):
        i, c = divmod(g, C)
        mine = sorted((s.r0, p[(i - s.i0) * C + c])
                      for s, p in zip(shares, parts) if s.i0 <= i < s.i1)
        streams.append(stitch_streams([b for _, b in mine]))
    return streams


def _device_entropy(levels: Sequence[torch.Tensor]) -> List[List[bytes]]:
    """Per share: one phase-1 stats pull, then K1 + K2 over all its planes
    (``DC.encode_stream_sized``), the stream split by plane bytes.  Every
    amplitude is checked before any entropy coding."""
    flats, pulled = [], []
    for lv in levels:
        flat = lv.reshape(-1, lv.shape[-1])
        bb = DC.block_bytes_of(flat).to(torch.int64)
        flats.append(flat)
        pulled.append(torch.cat([
            torch.stack([bb.max(), bb.sum(), flat.abs().max().to(torch.int64)]),
            bb.reshape(lv.shape[0], -1).sum(dim=-1)]))
    pulled = [st.cpu().tolist() for st in pulled]
    for st in pulled:
        _check_amp(st[2])
    coded = [DC.encode_stream_sized(flat, -(-st[0] // 4), st[1])
             for flat, st in zip(flats, pulled)]
    out = []
    for (buf, _, bad), st in zip(coded, pulled):
        DC.check_sized_ok(bad.cpu())
        raw = buf.cpu().numpy().tobytes()
        offs = np.cumsum([0] + st[3:])
        out.append([raw[offs[k]:offs[k + 1]] for k in range(len(st) - 3)])
    return out


def _host_entropy(levels: Sequence[torch.Tensor]) -> List[List[bytes]]:
    """Per share: the levels pulled, each plane coded by the host codec on
    a thread pool (the C++ codec releases the GIL)."""
    host = [lv.cpu().numpy() for lv in levels]
    jobs = [plane for lv in host for plane in lv]
    with ThreadPoolExecutor(max_workers=min(16, max(1, len(jobs)))) as pool:
        coded = iter(list(pool.map(entropy.encode_levels, jobs)))
    return [[next(coded) for _ in lv] for lv in host]


def _shard_stream_slices(streams: Sequence[bytes],
                         scans: Sequence[np.ndarray],
                         ranges: Sequence[Sequence[Tuple[int, int, int]]]
                         ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Cut a batch of byte-aligned plane streams into per-share slices.

    ``ranges[k]`` lists share k's blocks as ``(plane, first, end)``.  Each
    block's start byte is known from the host scan, so a share's blocks of
    one plane are one contiguous byte range: share k gets only those
    ranges' bytes, concatenated, and their blocks' starts within that
    slice (int64).  The decode dual of the encode's stitch: no device
    holds the whole batch stream.
    """
    out = []
    for rng in ranges:
        pieces, starts, off = [], [], 0
        for g, a, b in rng:
            sc, s = scans[g], streams[g]
            lo = int(sc[a])
            hi = int(sc[b]) if b < len(sc) else len(s)
            pieces.append(np.frombuffer(s, np.uint8)[lo:hi])
            starts.append(sc[a:b].astype(np.int64) - lo + off)
            off += hi - lo
        out.append((np.concatenate(pieces), np.concatenate(starts)))
    return out


def _share_blocks(s: Share, C: int, bw: int) -> List[Tuple[int, int, int]]:
    """A share's blocks as ``(plane, first, end)`` per plane."""
    return [(g, s.r0 * bw, s.r1 * bw) for g in range(s.i0 * C, s.i1 * C)]


def _scan_streams(streams: Sequence[bytes],
                  config: Configuration) -> List[np.ndarray]:
    """Every plane's block starts from the host C++ scanner (which also
    validates the stream), on a thread pool: the scanner releases the
    GIL."""
    nb, L = config.num_blocks, config.dct_size ** 2
    with ThreadPoolExecutor(max_workers=min(16, len(streams))) as pool:
        return list(pool.map(
            lambda s: entropy.scan_offsets(s, nb, L, scan="host"), streams))


def _parse_shares(streams: Sequence[bytes], scans: Sequence[np.ndarray],
                  config: Configuration, shares: Sequence[Share],
                  C: int) -> List[torch.Tensor]:
    """Upload each share's slice of the streams once and launch one K3 a
    share: its ``(blocks, L)`` int32 levels on its device."""
    L, bw = config.dct_size ** 2, config.blocks_wide
    slices = _shard_stream_slices(streams, scans,
                                  [_share_blocks(s, C, bw) for s in shares])
    return [DC.decode_stream(torch.from_numpy(buf).to(s.device),
                             torch.from_numpy(st).to(s.device), L)
            for s, (buf, st) in zip(shares, slices)]


def _host_parse_shares(streams: Sequence[bytes], config: Configuration,
                       shares: Sequence[Share],
                       C: int) -> List[torch.Tensor]:
    """The host codec decodes every plane's levels (thread pool); each
    share's are uploaded to its device."""
    nb, L, bw = config.num_blocks, config.dct_size ** 2, config.blocks_wide
    with ThreadPoolExecutor(max_workers=min(16, len(streams))) as pool:
        host = np.stack(list(pool.map(
            lambda s: entropy.decode_levels(s, nb, L), streams)))
    return [torch.from_numpy(np.ascontiguousarray(
        host[s.i0 * C:s.i1 * C, s.r0 * bw:s.r1 * bw])).to(s.device)
        for s in shares]


def _decode_share_planes(levels: Sequence[torch.Tensor],
                         config: Configuration, shares: Sequence[Share],
                         dtype) -> List[torch.Tensor]:
    """Each share's levels -> its planes' rows on its device
    (``BandDecoder``: K4 wherever the dequantizer is an integer)."""
    L = config.dct_size ** 2
    out = []
    for s, lv in zip(shares, levels):
        cfg, _, _ = _row_config(config, s.r0, s.r1)
        out.append(BandDecoder(cfg, dtype, device=s.device, _image=config)(
            lv.reshape(-1, cfg.num_blocks, L)))
    return out


def _pull_planes(planes: Sequence[torch.Tensor], config: Configuration,
                 shares: Sequence[Share], C: int, n: int) -> np.ndarray:
    """Every share's rows pulled into one ``(n, H, W)`` uint8 host array."""
    out = np.empty((n, config.height, config.width), np.uint8)
    for s, p in zip(shares, planes):
        _, y0, y1 = _row_config(config, s.r0, s.r1)
        out[s.i0 * C:s.i1 * C, y0:y1] = p.cpu().numpy()
    return out


def _decode_shares(streams: Sequence[bytes], config: Configuration,
                   shares: Sequence[Share], C: int, dtype,
                   device_entropy: bool) -> np.ndarray:
    """Decode ``images * C`` plane streams (image-major) into an
    ``(images * C, H, W)`` uint8 host array."""
    if device_entropy:
        levels = _parse_shares(streams, _scan_streams(streams, config),
                               config, shares, C)
    else:
        levels = _host_parse_shares(streams, config, shares, C)
    planes = _decode_share_planes(levels, config, shares, dtype)
    return _pull_planes(planes, config, shares, C, len(streams))


def _default_entropy(mesh: mesh_lib.Mesh,
                     device_entropy: Optional[bool]) -> bool:
    """``None``: entropy coding on the device when the mesh's devices are
    CUDA devices, else on the host (the JAX package's TPU-backend rule)."""
    if device_entropy is None:
        return all(d.type == "cuda" for d in mesh.devices.flat)
    return bool(device_entropy)


def _plane_stack(plane, config: Configuration) -> np.ndarray:
    plane = np.asarray(plane)
    if plane.ndim != 2:
        raise ValueError(f"expected an (H, W) plane, got {plane.shape}")
    check_band_shape(plane.shape, config)
    return plane[None, :, :, None]


def encode_batch_levels(bands, config: Configuration, mesh: mesh_lib.Mesh,
                        dtype=None) -> Tuple[np.ndarray, int]:
    """Batch-of-bands coefficient path on the mesh.

    Args:
      bands: (B, H, W) integer host array of same-size image bands.
    Returns:
      ((B, num_blocks, L) int32 levels, exact total payload bytes).
    """
    bands = np.asarray(bands)
    if bands.ndim != 3:
        raise ValueError(f"expected (B, H, W) bands, got {bands.shape}")
    check_band_shape(bands.shape[1:], config)
    shares = batch_shares(mesh, config, bands.shape[0])
    levels = [_share_levels(bands[..., None], config, s, dtype)
              for s in shares]
    totals = [stats.total_bytes(lv) for lv in levels]
    L, bw = config.dct_size ** 2, config.blocks_wide
    out = np.empty((bands.shape[0], config.num_blocks, L), np.int32)
    for s, lv in zip(shares, levels):
        out[s.i0:s.i1, s.r0 * bw:s.r1 * bw] = lv.cpu().numpy()
    return out, int(sum(int(t) for t in totals))


def compress_plane(plane, config: Configuration, mesh: mesh_lib.Mesh,
                   dtype=None) -> bytes:
    """Row-band-tiled single-plane compress, entropy-coded on the host.

    Every share runs the whole image's ``BandEncoder`` branch, so the
    sharded bytes equal the port's serial bytes (``api.compress_band``) in
    f32 and f64."""
    return _encode_shares(_plane_stack(plane, config), config,
                          row_shares(mesh, config), dtype, False)[0]


def compress_plane_device_entropy(plane, config: Configuration,
                                  mesh: mesh_lib.Mesh, dtype=None) -> bytes:
    """Row-band compress with each share's stream assembled on its device
    (K1, K2); the host pulls each share's stream and concatenates.  An
    unrepresentable amplitude raises ``BadRleCodeError`` before any
    entropy coding."""
    return _encode_shares(_plane_stack(plane, config), config,
                          row_shares(mesh, config), dtype, True)[0]


def decompress_plane(data: bytes, config: Configuration,
                     mesh: mesh_lib.Mesh, dtype=None,
                     device_entropy: Optional[bool] = None) -> np.ndarray:
    """Row-band-tiled decode of ONE band stream into an (H, W) int32 plane,
    the dual of :func:`compress_plane_device_entropy`; equal to
    ``api.decompress_band``.  The host runs only the serial boundary scan;
    each share's bit parse (K3) and coefficient decode run on its device.
    With ``device_entropy=False`` the host codec decodes the levels."""
    planes = _decode_shares([bytes(data)], config, row_shares(mesh, config),
                            1, dtype, _default_entropy(mesh, device_entropy))
    return planes[0].astype(np.int32)


def compress_batch(images, config: Configuration, mesh: mesh_lib.Mesh,
                   dtype=None, device_entropy: Optional[bool] = None
                   ) -> List[bytes]:
    """(B, H, W, 3) uint8 YCbCr batch -> list of B container blobs, equal
    to per-image ``compress_ycbcr``.

    Each share runs the coefficient path of its ``3 * B_share`` planes in
    one call.  Entropy on the device (the default on CUDA meshes): one
    stats pull, one K1 and one K2 a share; on the host: the C++ codec on a
    thread pool.
    """
    images = np.asarray(images)
    if images.ndim != 4 or images.shape[3] != 3:
        raise ValueError(f"expected (B, H, W, 3) batch, got {images.shape}")
    check_band_shape(images.shape[1:3], config)
    streams = _encode_shares(images, config,
                             batch_shares(mesh, config, images.shape[0]),
                             dtype, _default_entropy(mesh, device_entropy))
    return [container.generate_data(config, CompressedData(*streams[k:k + 3]))
            for k in range(0, len(streams), 3)]


def decompress_batch(blobs: Sequence[bytes], mesh: mesh_lib.Mesh, dtype=None,
                     device_entropy: Optional[bool] = None) -> np.ndarray:
    """List of container blobs (same config) -> (B, H, W, 3) uint8 batch,
    equal to per-image ``decompress_to_ycbcr``.  With device entropy (the
    default on CUDA meshes) the host runs only the boundary scans and each
    share's slice of the streams is uploaded once: one K3 a share."""
    parsed = [container.read_data(b) for b in blobs]
    config = parsed[0][0]
    streams = []
    for cfg, data in parsed:
        if cfg != config:
            raise ValueError("decompress_batch requires a homogeneous batch")
        streams.extend([data.y, data.cb, data.cr])
    planes = _decode_shares(streams, config,
                            batch_shares(mesh, config, len(blobs)), 3, dtype,
                            _default_entropy(mesh, device_entropy))
    return planes.reshape(len(blobs), 3, config.height,
                          config.width).transpose(0, 2, 3, 1)
