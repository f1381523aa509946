#!/usr/bin/env python3
"""Time jpeg_tpu_torch's K4 (``decode_blocks``) and K2 (``deposit_rows``)
and the stages around them on one NVIDIA GPU, for comparing two trees of
the package in one call on one card.

    python3 benchmarks/torch_kernel_ab.py [--root DIR] [--label NAME]

imports ``jpeg_tpu_torch`` from DIR (default: this checkout), builds its
kernels there, and times, on ``chip_smoke.py``'s synthetic images (seed 7;
qtable, DCT, d 8, bs 2 at 2048x2048 and 3840x2160; BASELINE (3), bs 4,
d 24, divide 1000, at 2048x2048):

* K4 on each configuration's own levels, its plain version and one
  full-f32 ``torch.matmul`` of the same operands (CUDA events, mean of 50
  launches; plain and matmul 10);
* K2 on the 2048x2048 image's rows, its plain version, and the device
  kernels of one call (``torch.profiler`` CUDA events: count and us);
* the "K1 + K2" encode stage (``encode_stream_sized``) and the "K4 +
  layout" decode stage (``BandDecoder``), each ended by a device sync,
  host clock, median of 7;
* encode and decode host->host (``compress_ycbcr``,
  ``decompress_to_ycbcr``), CUDA events around calls that end on the host,
  median of 7.

Prints one line per number and, last, a JSON object of them with the
card's ``name, power.limit``.  Uses only calls that older trees of the
port have too (the kernel wrappers, ``BandEncoder`` / ``BandDecoder``,
``encode_stream_sized``, the image API), so it can time an older
checkout beside this one.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPS = 7


def synth_image(h: int, w: int) -> np.ndarray:
    """``chip_smoke.py``'s generator (``bench.py``'s, seed 7)."""
    rng = np.random.default_rng(7)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    out = []
    for c in range(3):
        plane = (128
                 + 70 * np.sin(x / (17 + 6 * c)) * np.cos(y / (23 - 4 * c))
                 + 30 * np.sin((x + y) / (9 + 2 * c))
                 + 8 * rng.standard_normal((h, w)))
        out.append(np.clip(plane, 0, 255))
    return np.stack(out, axis=-1).astype(np.uint8)


def mean_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def fenced_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def call_ms(fn) -> float:
    fn()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_kernels(fn):
    """(count, us) of the device kernels one call of fn runs."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.events()
           if ev.device_type == torch.autograd.DeviceType.CUDA]
    return len(evs), sum(ev.time_range.elapsed_us() for ev in evs), sorted(
        {ev.name[:40] for ev in evs})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_ab: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from jpeg_tpu_torch import (Configuration, QuantizationMethod,
                                compress_ycbcr, decompress_to_ycbcr)
    from jpeg_tpu_torch.entropy import device_codec as DC
    from jpeg_tpu_torch.ops import kernels as K
    from jpeg_tpu_torch.ops.band import BandDecoder, BandEncoder
    from jpeg_tpu_torch.utils.device import full_f32_matmul

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    K.build()
    K._library()
    tag = args.label or os.path.abspath(args.root)
    print(f"[{tag}] built in {time.perf_counter() - t0:.1f} s; {card}",
          flush=True)
    res = {"label": tag, "card": card}

    def log(key, value):
        res[key] = value
        print(f"[{tag}] {key}: {value}", flush=True)

    configs = {
        "2048x2048": ((2048, 2048), 2, 8, ("qtable", {})),
        "3840x2160": ((2160, 3840), 2, 8, ("qtable", {})),
        "d24 2048x2048": ((2048, 2048), 4, 24, ("divide", {"divisor": 1000})),
    }
    for name, ((h, w), bs, d, (qn, qp)) in configs.items():
        cfg = Configuration(width=w, height=h, block_size=bs, dct_size=d,
                            quantization=QuantizationMethod(qn, **qp))
        img = synth_image(h, w)
        img_t = torch.from_numpy(img).to(dev).permute(2, 0, 1)
        levels = BandEncoder(cfg).to(dev)(img_t)            # (3, N, L)
        L = d * d
        flat = levels.reshape(-1, L).contiguous()
        bdec = BandDecoder(cfg).to(dev)
        a32 = (flat * bdec.deq).to(torch.float32)

        def matmul(a32=a32, op_t=bdec.op_t):
            with full_f32_matmul():
                return torch.matmul(a32, op_t)

        # K4 as the tree's band decoder calls it: the (K, d*d) operator and
        # bs where its wrapper takes one, else the combined operator
        kw = ({"bs": bs} if "bs" in inspect.signature(
            K.decode_blocks).parameters and bdec.op_t.shape[1] == L else {})
        shape = f"N={flat.shape[0]}, K={L}, M={bdec.op_t.shape[1]}, {kw}"
        log(f"K4 {name} ms ({shape})", mean_ms(
            lambda: K.decode_blocks(flat, bdec.op_t, bdec.deq, **kw), 50))
        log(f"K4 {name} plain ms", mean_ms(
            lambda: K.decode_blocks_plain(flat, bdec.op_t, bdec.deq, **kw),
            10))
        log(f"K4 {name} matmul ms", mean_ms(matmul, 10))
        log(f"stage K4 + layout {name} ms", fenced_ms(lambda: bdec(levels)))
        if d != 8:
            continue
        bb = DC.block_bytes_of(flat)
        W = -(-int(bb.max()) // 4)
        total = int(bb.to(torch.int64).sum())
        log(f"stage K1 + K2 {name} ms", fenced_ms(
            lambda: DC.encode_stream_sized(flat, W, total)))
        rows, bbk = K.encode_stream_rows(flat, W)
        if name == "2048x2048":
            log(f"K2 {name} ms (N={flat.shape[0]}, W={W}, {total} bytes)",
                mean_ms(lambda: K.deposit_rows(rows, bbk, total), 50))
            log(f"K2 {name} plain ms", mean_ms(
                lambda: K.deposit_rows_plain(rows, bbk, total), 10))
            n, us, names = device_kernels(
                lambda: K.deposit_rows(rows, bbk, total))
            log(f"K2 {name} device kernels a call", n)
            log(f"K2 {name} device us a call", us)
            log(f"K2 {name} device kernel names", names)
        blob = compress_ycbcr(img, cfg)
        log(f"encode {name} host->host ms", call_ms(
            lambda: compress_ycbcr(img, cfg)))
        log(f"decode {name} host->host ms", call_ms(
            lambda: decompress_to_ycbcr(blob)))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
