"""Batch driver: compress/decompress a directory of images with metrics.

Counterpart of ``jpeg_tpu/cli/batch.py``.  The reference has no batch
mode, no failure handling and no observability (SURVEY.md §5).  This
driver adds the minimum production surface:

* **Resume**: an image whose output file already exists is skipped, so an
  interrupted job re-run picks up where it left off.
* **Failure detection**: unreadable/corrupt inputs are skipped and reported
  (exit code 1 if anything failed) instead of aborting the whole job.
* **Metrics**: one JSON line per run — megapixels/s, compressed bytes,
  compression ratio, failures, optional mean PSNR (with --verify the driver
  decodes each output and scores it against the input).
* **Grouped dispatch**: with ``--mesh``, same-size images go through the
  sharded path (``parallel.compress_batch``) together, so each device
  share codes its images' planes in one stats pull, one K1 and one K2.

``--device`` (default ``cuda``) picks where the codec runs; ``cpu`` runs
the kernels' plain PyTorch versions.  ``--distributed`` runs one process
of several over ``torch.distributed`` (gloo; ``parallel.multihost``).
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, List, Tuple

import numpy as np

from ..api import compress_many, decompress_many, decompress_to_ycbcr, psnr
from ..config import Configuration
from ..utils.device import resolve_device
from ..utils.profiling import Metrics
from .compress import add_device_flag, device_mesh, quantization_from_args

IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".gif", ".tiff", ".webp"}


def _load_ycbcr(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("YCbCr"))


def _image_paths(indir: str) -> List[str]:
    return sorted(os.path.join(indir, f) for f in os.listdir(indir)
                  if os.path.splitext(f)[1].lower() in IMAGE_EXTS)


def _group_by_size(paths: List[str]) -> Tuple[Dict[Tuple[int, int], List[str]],
                                              Dict[str, str]]:
    """Probe image headers; group readable files by (H, W)."""
    from PIL import Image
    groups: Dict[Tuple[int, int], List[str]] = {}
    errors: Dict[str, str] = {}
    for p in paths:
        try:
            with Image.open(p) as im:
                key = (im.height, im.width)
        except Exception as e:  # noqa: BLE001
            errors[p] = f"unreadable: {e}"
            continue
        groups.setdefault(key, []).append(p)
    return groups, errors


def _group_config(h: int, w: int, args) -> Configuration:
    return Configuration(width=w, height=h, block_size=args.block_size,
                         dct_size=args.dct_size, transform=args.transform,
                         quantization=quantization_from_args(args))


def _pending(members: List[str], outdir: str, ext: str, args,
             report: bool = True) -> List[Tuple[str, str]]:
    """(input, output) pairs whose output does not exist yet (or all of
    them with ``--force``)."""
    pending = []
    for p in members:
        out = os.path.join(
            outdir, os.path.splitext(os.path.basename(p))[0] + ext)
        if os.path.exists(out) and not args.force:
            if report:
                print(f"RESUME-SKIP {out} exists", file=sys.stderr)
            continue
        pending.append((p, out))
    return pending


def run(indir: str, outdir: str, args, mesh=None) -> Metrics:
    os.makedirs(outdir, exist_ok=True)
    metrics = Metrics()
    groups, errors = _group_by_size(_image_paths(indir))
    for p, why in errors.items():
        print(f"SKIP {p}: {why}", file=sys.stderr)
        metrics.failures += 1

    for (h, w), members in sorted(groups.items()):
        config = _group_config(h, w, args)
        pending = _pending(members, outdir, ".jc", args)
        if not pending:
            continue

        arrays, items = [], []
        for p, out in pending:
            try:
                arrays.append(_load_ycbcr(p))
                items.append((p, out))
            except Exception as e:  # noqa: BLE001
                print(f"SKIP {p}: decode failed: {e}", file=sys.stderr)
                metrics.failures += 1

        t0 = time.perf_counter()
        if mesh is not None and len(arrays) > 1:
            from .. import parallel
            blobs = parallel.compress_batch(np.stack(arrays), config, mesh)
        else:
            # Pipelined: image i+1 uploads and launches while image i's
            # compressed bytes come back (api.compress_many).
            blobs = compress_many(arrays, config, device=args.device)
        dt = time.perf_counter() - t0

        for (p, out), arr, blob in zip(items, arrays, blobs):
            with open(out, "wb") as f:
                f.write(blob)
            q = None
            if args.verify:
                q = psnr(arr, decompress_to_ycbcr(blob, device=args.device))
            metrics.add_image(h, w, len(blob), dt / max(1, len(items)), q)
            if args.verbose:
                print(f"OK {p} -> {out} ({len(blob)} bytes)", file=sys.stderr)
    return metrics


def run_distributed(indir: str, outdir: str, args) -> Metrics:
    """Multi-process data-parallel batch encode (BASELINE config 5's
    shape): process p owns the pending images with index % nproc == p,
    encodes them on its own device, and writes only its own outputs;
    per-image byte counts cross processes as a manifest so every process
    reports identical global metrics
    (``parallel.multihost.compress_batch_distributed``).

    Assumes every process sees the same ``indir`` listing and output
    existence (a shared filesystem, or replicas) — ownership is derived
    from the shared pending order.
    """
    from ..parallel import multihost

    os.makedirs(outdir, exist_ok=True)
    metrics = Metrics()
    pid = multihost.process_index()
    groups, errors = _group_by_size(_image_paths(indir))
    for p, why in errors.items():
        print(f"SKIP {p}: {why}", file=sys.stderr)
    metrics.failures += len(errors)

    for (h, w), members in sorted(groups.items()):
        config = _group_config(h, w, args)
        pending = _pending(members, outdir, ".jc", args, report=pid == 0)
        if not pending:
            continue

        t0 = time.perf_counter()
        loaders = [(lambda q=p: _load_ycbcr(q)) for p, _ in pending]
        blobs, manifest = multihost.compress_batch_distributed(
            loaders, config, verify=args.verify, device=args.device)
        dt = time.perf_counter() - t0

        n_ok = int(manifest[:, 1].sum())
        for i, ((p, out), blob) in enumerate(zip(pending, blobs)):
            if blob is not None:
                with open(out, "wb") as f:
                    f.write(blob)
                if args.verbose:
                    print(f"OK {p} -> {out} ({len(blob)} bytes)",
                          file=sys.stderr)
            if manifest[i, 1]:
                q = manifest[i, 2] / 1000 if manifest[i, 2] >= 0 else None
                metrics.add_image(h, w, int(manifest[i, 0]),
                                  dt / max(1, n_ok), q)
            else:
                metrics.failures += 1
    return metrics


def run_decompress(indir: str, outdir: str, args) -> Metrics:
    """Batch decode: .jc containers -> .png, resumable and skip-and-report.

    Decode is pipelined (api.decompress_many): blob i+1's host scan and
    kernel launches overlap blob i's plane download and PNG write.
    """
    os.makedirs(outdir, exist_ok=True)
    paths = sorted(os.path.join(indir, f) for f in os.listdir(indir)
                   if f.endswith(".jc"))
    metrics = Metrics()
    pending = _pending(paths, outdir, ".png", args)

    blobs, items = [], []
    for p, out in pending:
        try:
            with open(p, "rb") as f:
                blobs.append(f.read())
            items.append((p, out))
        except OSError as e:
            print(f"SKIP {p}: unreadable: {e}", file=sys.stderr)
            metrics.failures += 1

    from PIL import Image

    # A corrupt blob must not abort the batch, but restarting per-blob
    # would re-decode every good blob serially.  Bisect instead: a failing
    # group splits in half, so one bad blob costs O(log n) extra pipelined
    # passes and every good blob keeps the pipelining.
    def _decode_group(group_blobs, group_items):
        try:
            return decompress_many(group_blobs, device=args.device)
        except Exception as e:  # noqa: BLE001
            if len(group_blobs) == 1:
                p = group_items[0][0]
                print(f"SKIP {p}: corrupt container: {e}", file=sys.stderr)
                metrics.failures += 1
                return [None]
            mid = len(group_blobs) // 2
            return (_decode_group(group_blobs[:mid], group_items[:mid])
                    + _decode_group(group_blobs[mid:], group_items[mid:]))

    t0 = time.perf_counter()
    imgs = _decode_group(blobs, items)
    dt = time.perf_counter() - t0
    n_ok = sum(1 for im in imgs if im is not None)
    for (p, out), arr in zip(items, imgs):
        if arr is None:
            continue
        Image.fromarray(arr, "YCbCr").convert("RGB").save(out)
        metrics.add_image(arr.shape[0], arr.shape[1],
                          os.path.getsize(p), dt / max(1, n_ok), None)
        if args.verbose:
            print(f"OK {p} -> {out}", file=sys.stderr)
    return metrics


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Batch-compress (or --decompress) a directory, resumable")
    p.add_argument("indir")
    p.add_argument("outdir")
    p.add_argument("--block_size", type=int, default=4)
    p.add_argument("--dct_size", type=int, default=8)
    p.add_argument("--transform", type=str, default="DCT")
    p.add_argument("--quantization", type=str, default="qtable")
    p.add_argument("--qkeep", type=int, default=2)
    p.add_argument("--qdivisor", type=int, default=40)
    p.add_argument("--force", action="store_true",
                   help="recompress even if output exists")
    p.add_argument("--verify", action="store_true",
                   help="decode each output and report PSNR")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--mesh", action="store_true",
                   help="batch same-size images through the device mesh")
    p.add_argument("--decompress", action="store_true",
                   help="decode .jc containers back to .png instead")
    p.add_argument("--distributed", action="store_true",
                   help="multi-process DP over the image set: run one "
                        "process per host or GPU with --coordinator/--nproc/"
                        "--procid; process p encodes images with index "
                        "%% nproc == p")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of process 0 (torch.distributed, gloo)")
    p.add_argument("--nproc", type=int, default=None)
    p.add_argument("--procid", type=int, default=None)
    add_device_flag(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)    # a missing GPU raises before any work
    if args.distributed:
        from ..parallel import multihost
        multihost.initialize(args.coordinator, args.nproc, args.procid)
        try:
            metrics = run_distributed(args.indir, args.outdir, args)
        finally:
            multihost.shutdown()
    elif args.decompress:
        metrics = run_decompress(args.indir, args.outdir, args)
    else:
        mesh = device_mesh(args.device) if args.mesh else None
        metrics = run(args.indir, args.outdir, args, mesh=mesh)
    print(metrics.json_line())
    return 1 if metrics.failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
