#!/usr/bin/env python3
"""How a container's band bytes best reach one GPU: straight from the
caller's pageable buffer, through a cached page-locked staging block, or
from the caller's buffer page-locked in place.

    python3 benchmarks/torch_stream_upload.py [--sizes 30000,1400000] \
        [--reps 60] [--seed N] [--out stream_upload.json]

For each size, one seeded container-like ``bytes`` object is made: a
header, then three bands of a third of the size each behind a u32 length
field.  Five routes move the bands to the device, timed on the host clock
from the call to the end of the copy on the device
(``torch.cuda.synchronize``), every route warm (5 calls each first), the
routes alternating call by call in a rotating order:

* ``copies``: each band copied out, the copies joined, the join copied
  into a ``bytearray`` and that moved (the decode's path before it read
  the bands in place);
* ``pageable``: one tensor over the caller's bytes from the first band to
  the last band's end, moved with ``.to`` (``DC.upload_stream``, the
  decode's path now);
* ``pinned``: the same bytes copied by one thread into a page-locked block
  allocated once, then moved from it with a non-blocking copy;
* ``pinned4``: the same in four parts, staged on four threads, each
  part's copy issued once it is staged;
* ``registered``: the caller's bytes page-locked where they lie
  (``cudaHostRegister``), moved with a non-blocking copy, and released;

and ``pinned_dma`` times the staging block's copy alone.  Each moved
stream is checked equal to the bands.  One torch thread, as in the
benchmark's runs.  Prints a row a size and route (median and
quartiles in ms, GB/s at the median), then one JSON object with the
card's ``name, power.limit``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from jpeg_tpu_torch.entropy import device_codec as DC  # noqa: E402

# The routes read the caller's read-only bytes in place.
warnings.filterwarnings("ignore", "The given buffer is not writable")

ROUTES = ("copies", "pageable", "pinned", "pinned4", "registered",
          "pinned_dma")
THREADS = 4
HEADER = 100


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def container_like(size: int, seed: int):
    """(bytes, [(offset, length)] of its three bands)."""
    rng = np.random.default_rng(seed)
    n = size // 3
    parts, spans, pos = [bytes(HEADER)], [], HEADER
    for _ in range(3):
        parts.append(n.to_bytes(4, "little"))
        parts.append(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
        spans.append((pos + 4, n))
        pos += 4 + n
    return b"".join(parts), spans


def routes(blob: bytes, spans, dev: torch.device, pool):
    first, (last, n_last) = spans[0][0], spans[-1]
    end = last + n_last
    staging = torch.empty(end - first, dtype=torch.uint8, pin_memory=True)
    region = memoryview(blob)[first:end]
    host = torch.frombuffer(region, dtype=torch.uint8)
    n = host.shape[0]
    cuts = [n * i // THREADS for i in range(THREADS + 1)]
    cudart = torch.cuda.cudart()

    def copies():
        bands = [bytes(blob[p:p + n]) for p, n in spans]
        return torch.frombuffer(bytearray(b"".join(bands)),
                                dtype=torch.uint8).to(dev)

    def pageable():
        return DC.upload_stream(region, dev)

    def pinned():
        staging.numpy()[:] = np.frombuffer(region, dtype=np.uint8)
        return staging.to(dev, non_blocking=True)

    def pinned4():
        out = torch.empty(n, dtype=torch.uint8, device=dev)

        def stage(i):
            staging[cuts[i]:cuts[i + 1]].copy_(host[cuts[i]:cuts[i + 1]])
        staged = [pool.submit(stage, i) for i in range(THREADS)]
        for i, done in enumerate(staged):
            done.result()
            out[cuts[i]:cuts[i + 1]].copy_(staging[cuts[i]:cuts[i + 1]],
                                           non_blocking=True)
        return out

    def registered():
        ptr = host.data_ptr()
        err = cudart.cudaHostRegister(ptr, n, 0)
        if int(err) != 0:
            raise RuntimeError(f"cudaHostRegister failed: {err}")
        try:
            out = host.to(dev, non_blocking=True)
            torch.cuda.current_stream(dev).synchronize()
        finally:
            cudart.cudaHostUnregister(ptr)
        return out

    def pinned_dma():
        return staging.to(dev, non_blocking=True)

    pinned()                                   # fill the block once
    return {"copies": copies, "pageable": pageable, "pinned": pinned,
            "pinned4": pinned4, "registered": registered,
            "pinned_dma": pinned_dma}


def bands_of(moved: torch.Tensor, spans, gaps: bool) -> bytes:
    host = moved.cpu().numpy().tobytes()
    if not gaps:
        return host
    first = spans[0][0]
    return b"".join(host[p - first:p - first + n] for p, n in spans)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="30000,1400000,8000000,47000000")
    ap.add_argument("--reps", type=int, default=60)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 24)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    torch.set_num_threads(1)
    pool = ThreadPoolExecutor(max_workers=THREADS)
    out = {"card": card(), "torch": torch.__version__, "reps": args.reps,
           "sizes": {}}
    for size in (int(s) for s in args.sizes.split(",")):
        blob, spans = container_like(size, args.seed + size)
        want = b"".join(blob[p:p + n] for p, n in spans)
        fns = routes(blob, spans, dev, pool)
        names = list(ROUTES)
        for name in ROUTES:
            try:
                got = bands_of(fns[name](), spans, gaps=name != "copies")
            except RuntimeError as e:          # a route the card refuses
                print(f"{size:>10} bytes  {name:<10} not run: {e}")
                names.remove(name)
                continue
            assert got == want, (size, name)
            for _ in range(4):
                fns[name]()
        torch.cuda.synchronize(dev)
        times = {name: [] for name in names}
        for rep in range(args.reps):
            k = rep % len(names)
            for name in names[k:] + names[:k]:
                t0 = time.perf_counter()
                fns[name]()
                torch.cuda.synchronize(dev)
                times[name].append(time.perf_counter() - t0)
        moved = sum(n for _, n in spans)
        row = {}
        for name in names:
            q1, med, q3 = statistics.quantiles(times[name], n=4)
            row[name] = {"median_ms": med * 1e3, "q1_ms": q1 * 1e3,
                         "q3_ms": q3 * 1e3, "gbps": moved / med / 1e9}
            print(f"{size:>10} bytes  {name:<10} median {med * 1e3:9.4f} "
                  f"ms (q1 {q1 * 1e3:9.4f}, q3 {q3 * 1e3:9.4f})  "
                  f"{moved / med / 1e9:7.2f} GB/s", flush=True)
        out["sizes"][str(size)] = row
    pool.shutdown()
    print(json.dumps(out), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
