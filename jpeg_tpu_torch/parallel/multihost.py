"""Multi-process execution over ``torch.distributed``: the cross-process
bitstream stitch and the data-parallel batch encode.

Counterpart of ``jpeg_tpu/parallel/multihost.py``.  The reference is
strictly single-process (SURVEY.md §2b).  Across processes:

* :func:`initialize` joins the process group (a no-op for one process).
  Each process runs the single-process machinery of
  :mod:`.sharded` on its own devices (:func:`global_mesh`).
* A plane's image rows are split as the JAX package splits them
  (:func:`host_rows`): ``height / devices`` rows a device of the global
  mesh, in rank order, whenever the height divides by the global device
  count.  A block row belongs to the process that holds its first image
  row; the rows it lacks from the next processes (fewer than
  ``dct_size * block_size``) reach it in one ``all_gather`` of every
  process's first rows, the halo.  Each process entropy-codes its own
  block rows, on the whole image's branch, then one ``all_gather`` of
  (first block row, length) and one of the padded streams fix the
  offsets, and every process materializes the identical stitched stream,
  which byte-aligned blocks make equal to the serial one.
* The batch encode owns images round-robin; only a per-image manifest
  crosses processes.

The backend is **gloo**, because what crosses processes is host bytes and
a small manifest, as in the JAX design (``process_allgather`` of host
arrays): the device work never leaves its process.  gloo also lets several
processes share one GPU, which NCCL does not (it needs a distinct GPU a
rank).  A run of one process per GPU over NCCL is therefore not what this
module does; with one GPU to hand it was not measured either.
"""
from __future__ import annotations

import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Configuration
from . import mesh as mesh_lib
from . import sharded


def _dist():
    import torch.distributed as dist
    return dist


def _initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the gloo process group at ``tcp://<coordinator_address>``
    (``host:port`` of process 0).  A no-op for one process."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator's "
                         "host:port and this process's id")
    _dist().init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)


def shutdown() -> None:
    """Leave the process group :func:`initialize` joined, if any."""
    if _initialized():
        _dist().destroy_process_group()


def process_count() -> int:
    return _dist().get_world_size() if _initialized() else 1


def process_index() -> int:
    return _dist().get_rank() if _initialized() else 0


def global_mesh(data: Optional[int] = None,
                band: Optional[int] = None) -> mesh_lib.Mesh:
    """Every CUDA device this process sees.  The global band order runs
    rank by rank: process p holds the rows :func:`host_rows` gives it,
    split over its own mesh."""
    return mesh_lib.make_mesh(data=data, band=band)


def _process_rows(config: Configuration, counts: Sequence[int],
                  pid: int) -> Optional[Tuple[int, int]]:
    """The JAX package's rows of process ``pid`` when process p holds
    ``counts[p]`` devices: ``height / sum(counts)`` image rows a device in
    rank order, or None when the height does not divide (the plane is
    then replicated)."""
    ndev = sum(counts)
    if config.height % ndev:
        return None
    per = config.height // ndev
    first = sum(counts[:pid])
    return per * first, per * (first + counts[pid])


def _block_rows(config: Configuration, y0: int, y1: int) -> Tuple[int, int]:
    """The block rows whose first image row lies in ``[y0, y1)``."""
    D = config.dct_size * config.block_size
    return -(-y0 // D), min(-(-y1 // D), config.blocks_high)


def host_rows(config: Configuration, nproc: Optional[int] = None,
              pid: Optional[int] = None,
              mesh: Optional[mesh_lib.Mesh] = None
              ) -> Tuple[int, int, int, int]:
    """Process ``pid``'s part of a plane, ``(r0, r1, y0, y1)``, under the
    JAX package's rule, each of the ``nproc`` processes holding as many
    devices as ``mesh`` (default :func:`global_mesh`).

    Image rows ``[y0, y1)``: ``height / (nproc * devices)`` rows a device,
    in rank order, whenever the height divides by the global device count
    (what :func:`compress_plane_distributed` takes and
    :func:`decompress_plane_distributed` returns); else the whole plane
    (what the decode returns; the encode raises).  Block rows ``[r0,
    r1)``: those whose first image row lies in ``[y0, y1)``, which this
    process encodes (possibly none)."""
    nproc = process_count() if nproc is None else nproc
    pid = process_index() if pid is None else pid
    n = (global_mesh() if mesh is None else mesh).devices.size
    y0, y1 = _process_rows(config, [n] * nproc, pid) or (0, config.height)
    return (*_block_rows(config, y0, y1), y0, y1)


def _all_gather(t: torch.Tensor) -> torch.Tensor:
    """(nproc, *t.shape) of every process's ``t`` (CPU tensors, gloo)."""
    dist = _dist()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out)


def _halo_rows(plane: np.ndarray, config: Configuration, counts,
               pid: int, y0: int, y1: int, r1: int) -> np.ndarray:
    """This process's rows followed by the rows ``[y1, min(r1 * D,
    height))`` that its last block row needs from the next processes.
    Every process sends its first ``D - 1`` rows (zero-padded), one
    ``all_gather``: a block row lacks fewer than D rows, and every row it
    lacks lies within the first D - 1 of the process holding it."""
    D = config.dct_size * config.block_size
    if D == 1:
        return plane
    first = np.zeros((D - 1, config.width), np.float64)
    first[:min(D - 1, len(plane))] = plane[:D - 1]
    halos = _all_gather(torch.from_numpy(first)).numpy()
    end = min(r1 * D, config.height)
    parts, have, k = [plane], y1, pid + 1
    while have < end:
        ky0, ky1 = _process_rows(config, counts, k)
        take = min(end, ky1) - ky0
        parts.append(halos[k, :take].astype(plane.dtype))
        have, k = ky0 + take, k + 1
    return np.concatenate(parts)


def compress_plane_distributed(plane, config: Configuration, mesh=None,
                               dtype=None) -> bytes:
    """Row-band compress across all processes; every process returns the
    full stitched stream, byte-equal to the serial encoder's.

    Args:
      plane: with one process, the full (H, W) band; with several, this
        process's rows ``[y0, y1)`` of :func:`host_rows`:
        ``height / devices`` rows for each of its devices.  A height that
        does not divide by the global device count raises ``ValueError``,
        as in the JAX package.
      mesh: this process's devices (default :func:`global_mesh`).
    """
    nproc, pid = process_count(), process_index()
    if mesh is None:
        mesh = global_mesh()
    plane = np.asarray(plane)
    info = [[mesh.devices.size,
             *(plane.shape if plane.ndim == 2 else (-1, -1))]]
    if nproc > 1:
        # Every process's device count and plane shape, so that every
        # process raises the same error, or none does.
        info = _all_gather(torch.tensor(info[0])).tolist()
    counts = [c for c, _, _ in info]
    if nproc > 1 and _process_rows(config, counts, 0) is None:
        raise ValueError(
            f"multi-host row-band tiling needs height {config.height} "
            f"divisible by {sum(counts)} devices")
    for p, (_, h, w) in enumerate(info):
        y0, y1 = _process_rows(config, counts, p) or (0, config.height)
        if (h, w) != (y1 - y0, config.width):
            raise ValueError(
                f"process {p} of {nproc} holds image rows [{y0}, {y1}) of "
                f"{config.height}: expected a plane of shape "
                f"{(y1 - y0, config.width)}, got {(h, w)}")
    if nproc <= 1:
        return sharded.compress_plane(plane, config, mesh, dtype=dtype)
    y0, y1 = _process_rows(config, counts, pid)
    r0, r1 = _block_rows(config, y0, y1)
    rows = _halo_rows(plane, config, counts, pid, y0, y1, r1)
    # This process's block rows, on the whole image's branch, entropy-coded
    # on the host as in the JAX package.
    local = b""
    if r0 < r1:
        D = config.dct_size * config.block_size
        local = sharded._encode_shares(
            rows[r0 * D - y0:][None, :, :, None], config,
            sharded._row_range_shares(mesh, r0, r1), dtype, False,
            y_off=r0 * D)[0]
    # All-gather (first block row, length), then the padded bytes; stitch
    # in global block order.  A process without block rows sends nothing.
    meta = _all_gather(torch.tensor([r0, len(local)], dtype=torch.int64))
    cap = max(int(meta[:, 1].max()), 1)
    padded = torch.zeros(cap, dtype=torch.uint8)
    if local:
        padded[:len(local)] = torch.frombuffer(bytearray(local),
                                               dtype=torch.uint8)
    streams = _all_gather(padded).numpy()
    meta = meta.numpy()
    return sharded.stitch_streams(
        [streams[p, :int(meta[p, 1])].tobytes()
         for p in np.argsort(meta[:, 0], kind="stable") if meta[p, 1]])


def decompress_plane_distributed(stream: bytes, config: Configuration,
                                 mesh=None, dtype=None) -> np.ndarray:
    """Distributed decode dual of :func:`compress_plane_distributed`.

    Args:
      stream: the FULL band stream, present on every process (as
        :func:`compress_plane_distributed` leaves it).
    Returns:
      this process's rows ``[y0, y1)`` of :func:`host_rows` as an int32
      plane, equal to the serial decoder's rows: the whole plane for one
      process, and where the height does not divide by the global device
      count (the JAX package replicates the plane there).

    Each process scans the whole stream on the host (scanning locally is
    cheaper than shipping offsets) and decodes only the block rows that
    hold its image rows, on its own devices; the one collective gathers
    the processes' device counts.
    """
    if mesh is None:
        mesh = global_mesh()
    y0, y1 = 0, config.height
    if process_count() > 1:
        n = torch.tensor([mesh.devices.size])
        counts = _all_gather(n).flatten().tolist()
        y0, y1 = _process_rows(config, counts, process_index()) or (y0, y1)
    D = config.dct_size * config.block_size
    shares = sharded._row_range_shares(mesh, y0 // D,
                                       _block_rows(config, y0, y1)[1])
    planes = sharded._decode_shares(
        [bytes(stream)], config, shares, 1, dtype,
        sharded._default_entropy(mesh, None))
    return planes[0, y0:y1].astype(np.int32)


def compress_batch_distributed(images, config: Configuration,
                               verify: bool = False, *, dtype=None,
                               device="cuda"):
    """Data-parallel multi-process BATCH encode (BASELINE config 5's
    shape).

    Every process receives the SAME ordered batch description; process p
    encodes the images whose index i satisfies ``i % nproc == p`` on its
    own ``device`` (``api.compress_many``), so pixels and container bytes
    never leave their process.  Only a per-image manifest (byte count, ok
    flag, optional PSNR in milli-dB) is all-gathered, so every process
    returns identical global metrics.

    Args:
      images: sequence over the FULL batch, identically ordered on every
        process.  Each element is an (H, W, 3) uint8 YCbCr array or a
        zero-argument callable returning one (only OWNED images are
        loaded).  All images must match ``config``'s dimensions.
      verify: decode each owned blob and record its PSNR.

    Returns:
      ``(blobs, manifest)``: ``blobs[i]`` is the container bytes of every
      image this process owns and ``None`` elsewhere; ``manifest`` is a
      (B, 3) int64 array, [bytes, ok, psnr_milli_db or -1], identical on
      every process (bytes = 0 marks a failed image).
    """
    from ..api import compress_many, decompress_to_ycbcr, psnr

    nproc, pid = process_count(), process_index()
    items = list(images)
    B = len(items)
    arrays, idxs = [], []
    local = np.zeros((B, 3), np.int64)
    local[:, 2] = -1
    for i in range(pid, B, nproc):
        try:
            a = items[i]() if callable(items[i]) else np.asarray(items[i])
            if a.shape[:2] != (config.height, config.width):
                raise ValueError(
                    f"image {i} is {a.shape[:2]}, config says "
                    f"{(config.height, config.width)}")
            arrays.append(a)
            idxs.append(i)
        except Exception as e:  # noqa: BLE001 — skip-and-report semantics
            print(f"SKIP image {i}: {e}", file=sys.stderr)

    blobs: List[Optional[bytes]] = [None] * B
    if arrays:
        encoded = compress_many(arrays, config, dtype, device=device)
        for i, a, blob in zip(idxs, arrays, encoded):
            blobs[i] = blob
            local[i, 0] = len(blob)
            local[i, 1] = 1
            if verify:
                local[i, 2] = int(round(1000 * psnr(
                    a, decompress_to_ycbcr(blob, dtype, device=device))))
    if nproc <= 1:
        return blobs, local
    # Manifest-only traffic: (nproc, B, 3) -> elementwise max keeps each
    # image's single owner entry (every other row is zero / -1).
    manifest = _all_gather(torch.from_numpy(local)).amax(dim=0).numpy()
    return blobs, manifest
