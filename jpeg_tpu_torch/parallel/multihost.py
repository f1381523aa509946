"""Multi-process execution over ``torch.distributed``: the cross-process
bitstream stitch and the data-parallel batch encode.

Counterpart of ``jpeg_tpu/parallel/multihost.py``.  The reference is
strictly single-process (SURVEY.md §2b).  Across processes:

* :func:`initialize` joins the process group (a no-op for one process).
  Each process runs the single-process machinery of
  :mod:`.sharded` on its own devices (:func:`global_mesh`).
* A plane's block rows are split over the processes in rank order
  (:func:`host_rows`); each process entropy-codes its own rows, then one
  ``all_gather`` of (first block row, length) and one of the padded
  streams fix the offsets, and every process materializes the identical
  stitched stream, which byte-aligned blocks make equal to the serial one.
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
from typing import List, Optional, Tuple

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


def host_rows(config: Configuration, nproc: Optional[int] = None,
              pid: Optional[int] = None) -> Tuple[int, int, int, int]:
    """Process ``pid``'s share of a plane: ``(r0, r1, y0, y1)``, block rows
    ``[r0, r1)`` and image rows ``[y0, y1)``, the block rows split in
    ``ceil(rows / nproc)`` parts in rank order (possibly empty at the
    end).  A row count divisible by ``nproc * dct_size * block_size``
    gives ``height // nproc`` rows each."""
    nproc = process_count() if nproc is None else nproc
    pid = process_index() if pid is None else pid
    rows = config.blocks_high
    per = -(-rows // nproc)
    r0, r1 = min(pid * per, rows), min((pid + 1) * per, rows)
    D = config.dct_size * config.block_size
    return r0, r1, min(r0 * D, config.height), min(r1 * D, config.height)


def _all_gather(t: torch.Tensor) -> torch.Tensor:
    """(nproc, *t.shape) of every process's ``t`` (CPU tensors, gloo)."""
    dist = _dist()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out)


def compress_plane_distributed(plane, config: Configuration, mesh=None,
                               dtype=None) -> bytes:
    """Row-band compress across all processes; every process returns the
    full stitched stream, byte-equal to the serial encoder's.

    Args:
      plane: with one process, the full (H, W) band; with several, this
        process's rows ``[y0, y1)`` of :func:`host_rows`.
      mesh: this process's devices (default :func:`global_mesh`).
    """
    nproc = process_count()
    if mesh is None:
        mesh = global_mesh()
    r0, r1, y0, y1 = host_rows(config, nproc, process_index())
    plane = np.asarray(plane)
    if plane.shape != (y1 - y0, config.width):
        raise ValueError(
            f"process {process_index()} of {nproc} holds image rows "
            f"[{y0}, {y1}) of {config.height}: expected a plane of shape "
            f"{(y1 - y0, config.width)}, got {plane.shape}")
    # This process's block rows, entropy-coded on the host as in the JAX
    # package, under the configuration of their height.
    local = b"" if r0 == r1 else sharded.compress_plane(
        plane, sharded._row_config(config, r0, r1)[0], mesh, dtype=dtype)
    if nproc <= 1:
        return local
    # All-gather (first block row, length), then the padded bytes; stitch
    # in global block order.  Duplicate starts would be the same rows held
    # twice: keep one copy.  A process without rows sends nothing.
    meta = _all_gather(torch.tensor([r0, len(local)], dtype=torch.int64))
    cap = max(int(meta[:, 1].max()), 1)
    padded = torch.zeros(cap, dtype=torch.uint8)
    if local:
        padded[:len(local)] = torch.frombuffer(bytearray(local),
                                               dtype=torch.uint8)
    streams = _all_gather(padded).numpy()
    meta = meta.numpy()
    parts, last_start = [], None
    for p in np.argsort(meta[:, 0], kind="stable"):
        if meta[p, 1] == 0 or int(meta[p, 0]) == last_start:
            continue
        last_start = int(meta[p, 0])
        parts.append(streams[p, :int(meta[p, 1])].tobytes())
    return sharded.stitch_streams(parts)


def decompress_plane_distributed(stream: bytes, config: Configuration,
                                 mesh=None, dtype=None) -> np.ndarray:
    """Distributed decode dual of :func:`compress_plane_distributed`.

    Args:
      stream: the FULL band stream, present on every process (as
        :func:`compress_plane_distributed` leaves it).
    Returns:
      this process's rows ``[y0, y1)`` of :func:`host_rows` as an int32
      plane, equal to the serial decoder's rows (the whole plane for one
      process).

    Each process scans the whole stream on the host (scanning locally is
    cheaper than shipping offsets) and decodes only its own block rows, on
    its own devices: no collective is needed.
    """
    if mesh is None:
        mesh = global_mesh()
    r0, r1, y0, y1 = host_rows(config)
    if r0 == r1:
        return np.zeros((0, config.width), np.int32)
    shares = [s._replace(r0=s.r0 + r0, r1=s.r1 + r0) for s in
              sharded.row_shares(mesh, sharded._row_config(config, r0,
                                                            r1)[0])]
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
