#!/usr/bin/env python3
"""Where a host->host decode's device boundary scan overtakes the host C++
scan, on one GPU.

    python3 benchmarks/torch_scan_crossover.py [--reps 200] [--seed N] \
        [--sizes 8x8,256x256] [--no-native] [--out scan_crossover.json]

For the two configurations of ``port_bench/configs/`` (``divide1000_d24_4k``
and ``cli_default_4k``) at each size (by default 8x8, 32x32, 64x64,
128x128, 256x256, 512x512, 1024x1024, 2048x2048 and 3840x2160; the
smallest are one block of stream), one frame of ``port_bench/frames.py`` is
encoded by the port, and ``decompress_to_ycbcr(blob, scan="host")`` is
timed against
``scan="device"`` on the host clock: every call warm (10 of each first),
``reps`` of each, the two scans alternating call by call (host first on
even reps, device first on odd).  The answers are checked bit-equal.
Prints a row a point (the three streams' total bytes, each scan's median
and quartiles in ms, host over device), then the crossover: the smallest
total from which the device scan won at every larger total of the sweep
(None where it lost at the largest), and the totals where the host scan
won.  Last, a JSON object of it all with the card's ``name,
power.limit``.  ``--no-native`` unloads the C++ scanner first, so that the
host scan is the pure-Python scanner.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CONFIGS = ("divide1000_d24_4k", "cli_default_4k")
SIZES = ("8x8,32x32,64x64,128x128,256x256,512x512,1024x1024,2048x2048,"
         "2160x3840")
SCANS = ("host", "device")


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def crossover(points) -> int | None:
    """The smallest total from which the device scan won at every larger
    total: ``points`` are (total bytes, host ms, device ms)."""
    best = None
    for total, host, device in sorted(points, reverse=True):
        if device >= host:
            break
        best = total
    return best


def probe(api, name: str, height: int, width: int, seed: int, reps: int,
          device) -> dict:
    import numpy as np
    from port_bench import program
    from port_bench.frames import synth_frames

    with open(os.path.join(ROOT, "port_bench", "configs",
                           f"{name}.json")) as f:
        codec = json.load(f)["codec"]
    cfg = program.configuration(api, codec, height, width)
    frame = synth_frames(1, height, width, seed, device)[0].cpu().numpy()
    blob = api.compress_ycbcr(frame, cfg, device=device)
    _, data = api.container.read_data(blob)
    total = len(data.y) + len(data.cb) + len(data.cr)

    answers = {s: api.decompress_to_ycbcr(blob, device=device, scan=s)
               for s in SCANS}
    if not np.array_equal(answers["host"], answers["device"]):
        raise AssertionError(f"{name} {height}x{width}: the scans differ")
    del answers
    for _ in range(10):
        for s in SCANS:
            api.decompress_to_ycbcr(blob, device=device, scan=s)
    times = {s: [] for s in SCANS}
    for r in range(reps):
        for s in (SCANS if r % 2 == 0 else SCANS[::-1]):
            t0 = time.perf_counter()
            api.decompress_to_ycbcr(blob, device=device, scan=s)
            times[s].append((time.perf_counter() - t0) * 1e3)
    row = {"config": name, "height": height, "width": width,
           "container_bytes": len(blob), "total_bytes": total}
    for s in SCANS:
        q1, q2, q3 = statistics.quantiles(times[s], n=4)
        row[s] = {"median_ms": statistics.median(times[s]),
                  "q1_ms": q1, "q3_ms": q3}
    row["host_over_device"] = (row["host"]["median_ms"]
                               / row["device"]["median_ms"])
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=3200000001)
    ap.add_argument("--sizes", default=SIZES,
                    help="comma-separated HxW, height first")
    ap.add_argument("--no-native", action="store_true",
                    help="host scan by the pure-Python scanner")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sizes = [tuple(map(int, hw.split("x"))) for hw in args.sizes.split(",")]

    import torch
    import jpeg_tpu_torch as api
    from jpeg_tpu_torch import entropy

    if args.no_native:
        entropy._native, entropy._native_checked = None, True
    device = torch.device("cuda", 0)
    info = {"card": card(), "torch": torch.__version__, "reps": args.reps,
            "seed": args.seed, "native": entropy._get_native() is not None,
            "rows": []}
    print(f"card: {info['card']}, torch {info['torch']}, "
          f"C++ scanner: {info['native']}", flush=True)
    print(f"{'config':>18} {'H x W':>10} {'total B':>9} "
          f"{'host ms (q1-q3)':>24} {'device ms (q1-q3)':>24} {'h/d':>6}")
    for name in CONFIGS:
        for h, w in sizes:
            row = probe(api, name, h, w, args.seed, args.reps, device)
            info["rows"].append(row)
            cells = [f"{row[s]['median_ms']:.4f} "
                     f"({row[s]['q1_ms']:.4f}-{row[s]['q3_ms']:.4f})"
                     for s in SCANS]
            print(f"{name:>18} {f'{h}x{w}':>10} {row['total_bytes']:>9} "
                  f"{cells[0]:>24} {cells[1]:>24} "
                  f"{row['host_over_device']:>6.3f}", flush=True)
    points = [(r["total_bytes"], r["host"]["median_ms"],
               r["device"]["median_ms"]) for r in info["rows"]]
    info["crossover_bytes"] = crossover(points)
    info["host_won_at"] = sorted(t for t, host, dev in points if dev >= host)
    print(f"crossover: {info['crossover_bytes']} bytes; the host scan won "
          f"at {info['host_won_at'] or 'no point'}")
    line = json.dumps(info)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
