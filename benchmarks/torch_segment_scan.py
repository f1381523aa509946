#!/usr/bin/env python3
"""The segmented boundary scan (K10) against K6's end table and K8's chase,
on one GPU: bit-equal starts and checks, device time and call time, from a
band of about a thousand blocks to a 24-MP photo's.

    python3 benchmarks/torch_segment_scan.py [--points photo:264x256,...] \
        [--segs 128,256,512,1024] [--reps 30] [--mutants 20] \
        [--seed N] [--out segment_scan.json]

Each point is a configuration of ``port_bench/configs/`` (``photo``:
``photo24mp_444``, ``cli``: ``cli_default_4k``, ``d24``:
``divide1000_d24_4k``) at a height x width.  Its frame
(``port_bench/frames.py``) is encoded by the port on the card and its
bands' stream moved there as a decode moves it.  Then:

* K6 + K8 (``device_scan.scan_bands_starts``) and K10
  (``kernels.segment_scan``) at each segment length give the same check,
  and the same starts where it holds, on the container and on
  ``--mutants`` malformed copies of it (bits flipped, bytes overwritten, a
  band's end one to four bytes short, a band run into the next length
  field); K10's unsynced walkers are printed;
* each scan's device time a call: the sum of its kernels' times in a
  ``torch.profiler`` session of ``reps`` calls, over ``reps``;
* each scan's call time: the median of ``reps`` host-clock times of a call
  and a synchronize, the scans alternating call by call;
* the decode's call time: the median of ``reps`` host-clock times of
  ``decompress_to_device(blob, scan="device")`` and a synchronize, with
  ``device_scan.SEGMENTED_MIN_BLOCKS`` set so that the decode takes K6 + K8,
  then K10, alternating call by call (the crossover of the engage rule).

Prints a row a point and scan, then a JSON object of it all with the card's
``name, power.limit``.
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

CONFIGS = {"photo": "photo24mp_444", "cli": "cli_default_4k",
           "d24": "divide1000_d24_4k"}
POINTS = ("d24:2160x3840,photo:264x256,photo:512x512,cli:2160x3840,"
          "photo:1440x1440,photo:2000x3000,photo:4000x6000")


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def bands(api, name, height, width, seed, device):
    """The container's bands as a decode moves them: (container, the
    bands' bytes, firsts, ends, blocks a band, coefficients a block)."""
    from port_bench import program
    from port_bench.frames import synth_frames

    with open(os.path.join(ROOT, "port_bench", "configs",
                           f"{name}.json")) as f:
        codec = json.load(f)["codec"]
    cfg = program.configuration(api, codec, height, width)
    frame = synth_frames(1, height, width, seed, device)[0].cpu().numpy()
    blob = api.compress_ycbcr(frame, cfg, device=device)
    config, spans = api.container.read_band_spans(blob)
    base = spans[0][0]
    firsts = [pos - base for pos, _ in spans]
    ends = [first + n for first, (_, n) in zip(firsts, spans)]
    raw = bytes(blob[base:base + ends[-1]])
    return (blob, raw, firsts, ends, config.num_blocks,
            config.dct_size ** 2)


def mutants(raw, firsts, ends, count, rng):
    """``count`` malformed copies of the bands: (bytes, ends)."""
    out = []
    for i in range(count):
        r, e = bytearray(raw), list(ends)
        kind = i % 5
        b = int(rng.integers(len(firsts)))
        if kind == 0:                        # bits flipped
            for _ in range(int(rng.integers(1, 4))):
                j = int(rng.integers(firsts[b], ends[b]))
                r[j] ^= 1 << int(rng.integers(8))
        elif kind == 1:                      # bytes overwritten
            n = min(32, ends[b] - firsts[b])
            j = int(rng.integers(firsts[b], ends[b] - n + 1))
            r[j:j + n] = bytes(rng.integers(0, 256, n).tolist())
        elif kind == 2:                      # a band 1-4 bytes short
            e[b] -= int(rng.integers(1, 5))
        elif kind == 3:                      # the last block runs on
            if b + 1 < len(firsts):
                e[b] += 2
            else:
                e[b] -= 1
        else:                                # the first byte garbled
            r[firsts[b]] ^= 0x5A
        out.append((bytes(r), e))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", default=POINTS)
    ap.add_argument("--segs", default="128,256,512,1024")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--mutants", type=int, default=20)
    ap.add_argument("--seed", type=int, default=3250000001)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import numpy as np
    import torch

    import jpeg_tpu_torch as api
    from jpeg_tpu_torch.entropy import device_scan as DS
    from jpeg_tpu_torch.ops import kernels as K

    dev = torch.device("cuda", 0)
    K.build()
    rng = np.random.default_rng(args.seed)
    segs = [int(s) for s in args.segs.split(",")]
    rows = []

    def k6k8(stream, firsts, ends, nb, L):
        starts, ok = DS.scan_bands_starts(stream, ends, nb, L, firsts)
        return starts, bool(ok), None

    def k10(seg):
        def run(stream, firsts, ends, nb, L):
            starts, status = K.segment_scan(stream, firsts, ends, nb, L, seg)
            rejected, unsynced = status.tolist()
            return starts, rejected == 0, unsynced
        return run

    scans = {"k6k8": k6k8, **{f"k10[{s}]": k10(s) for s in segs}}
    rule_before = DS.SEGMENTED_MIN_BLOCKS
    for point in args.points.split(","):
        tag, hw = point.split(":")
        h, w = (int(x) for x in hw.split("x"))
        blob, raw, firsts, ends, nb, L = bands(api, CONFIGS[tag], h, w,
                                               args.seed + h * w, dev)
        stream = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(dev)
        want = k6k8(stream, firsts, ends, nb, L)
        assert want[1], f"{point}: K6 + K8 rejected the container"
        row = {"point": point, "blocks_a_band": nb, "stream_bytes": len(raw),
               "scans": {}}
        for name, fn in scans.items():
            got = fn(stream, firsts, ends, nb, L)
            assert got[1] and torch.equal(got[0], want[0]), (point, name)
            row["scans"][name] = {"unsynced": got[2]}
        # malformed copies: the same check, the same starts where it holds
        held = 0
        for r, e in mutants(raw, firsts, ends, args.mutants, rng):
            s = torch.frombuffer(bytearray(r), dtype=torch.uint8).to(dev)
            ref = k6k8(s, firsts, e, nb, L)
            held += ref[1]
            for name, fn in scans.items():
                if name == "k6k8":
                    continue
                got = fn(s, firsts, e, nb, L)
                assert got[1] == ref[1], (point, name, "check")
                assert not ref[1] or torch.equal(got[0], ref[0]), (point,
                                                                    name)
        row["mutants"] = args.mutants
        row["mutants_held"] = held
        # device time a call: the profiler's kernels
        for name, fn in scans.items():
            fn(stream, firsts, ends, nb, L)
            torch.cuda.synchronize()
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(args.reps):
                    fn(stream, firsts, ends, nb, L)
                torch.cuda.synchronize()
            kernels = {}
            for ev in prof.events():
                if ev.device_type == torch.autograd.DeviceType.CUDA:
                    kernels[ev.name] = kernels.get(ev.name, 0.0) + \
                        ev.device_time_total
            row["scans"][name]["device_ms"] = sum(kernels.values()) / \
                args.reps / 1e3
            row["scans"][name]["kernels_ms"] = {
                k: v / args.reps / 1e3 for k, v in sorted(
                    kernels.items(), key=lambda kv: -kv[1])}
        # call time: a call and a synchronize, alternating
        times = {name: [] for name in scans}
        for rep in range(args.reps):
            order = list(scans.items())
            if rep % 2:
                order.reverse()
            for name, fn in order:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(stream, firsts, ends, nb, L)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
        for name in scans:
            row["scans"][name]["call_ms"] = statistics.median(times[name])
        # the decode's call time under each scan
        rules = {"k6k8": 1 << 62, "k10": 1}
        decode = {name: [] for name in rules}
        for rep in range(args.reps + 3):
            order = list(rules.items())
            if rep % 2:
                order.reverse()
            for name, rule in order:
                DS.SEGMENTED_MIN_BLOCKS = rule
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                api.decompress_to_device(blob, scan="device")
                torch.cuda.synchronize()
                if rep >= 3:                         # three warm calls
                    decode[name].append((time.perf_counter() - t0) * 1e3)
        DS.SEGMENTED_MIN_BLOCKS = rule_before
        row["decode_ms"] = {n: statistics.median(v)
                            for n, v in decode.items()}
        rows.append(row)
        for name, r in row["scans"].items():
            print(f"{point:>20} nb {nb:>7} {name:>10}  device "
                  f"{r['device_ms']:.4f} ms  call {r['call_ms']:.4f} ms  "
                  f"unsynced {r['unsynced']}", flush=True)
        print(f"{point:>20} mutants {args.mutants}, {held} held: equal; "
              f"decode k6k8 {row['decode_ms']['k6k8']:.4f} ms, k10 "
              f"{row['decode_ms']['k10']:.4f} ms", flush=True)
    result = {"card": card(), "seed": args.seed, "reps": args.reps,
              "rows": rows}
    text = json.dumps(result)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
