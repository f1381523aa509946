#!/usr/bin/env python3
"""GPU smoke run of jpeg_tpu_torch: build, check and time the codec's main
path on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order (any failure raises and exits non-zero, printing no
result):

1. Require a CUDA device; print ``nvidia-smi``'s card name and power limit
   and the torch / CUDA versions.
2. Build the four CUDA kernels from ``jpeg_tpu_torch/csrc`` with ``nvcc``
   (into ``build/cuda/``) and print the build time and ptxas' resource use.
3. Hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (2048x2048 image: N = 49,152 blocks, L = 64), on the
   image's own levels and on adversarial random levels: K1-K3 must be
   bit-equal, K4 equal except +-1 at provable ties (``utils/parity.py``).
4. Drive ``compress_ycbcr`` -> ``decompress_to_ycbcr`` at 2048x2048 and
   3840x2160 (qtable, DCT, dct_size 8, block_size 2) with every kernel's
   launch count reset just before and read just after.  Check that each
   band stream is byte-equal to the host C++ encoder's stream of the same
   levels, the container re-parses, the levels agree with the f64
   reference, PSNR is above 30 dB, the planes equal the plain-version path's
   on the card except +-1 at ties, and every kernel was launched.  With
   the caller's TF32 switched on, the container is the same bytes and the
   caller's setting is left as it was.
5. Time encode and decode (host array -> host bytes -> host array) with
   CUDA events, median of 7 after a warm-up, and each kernel against its
   plain version.

The last three lines of standard output are a JSON object of per-kernel
results, the card's ``name, power.limit`` and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SIZES = ((2048, 2048), (2160, 3840))       # (height, width)
REPS = 7
PSNR_MIN_DB = 30.0

KERNEL_INFO = {   # wrapper name -> (source, Pallas kernel it replaces)
    "encode_stream_rows": ("jpeg_tpu_torch/csrc/encode_stream.cu",
                           "jpeg_tpu/ops/pallas_kernels.py:393"),
    "deposit_rows": ("jpeg_tpu_torch/csrc/compact.cu",
                     "jpeg_tpu/ops/pallas_kernels.py:607"),
    "decode_stream_blocks": ("jpeg_tpu_torch/csrc/decode_stream.cu",
                             "jpeg_tpu/ops/pallas_kernels.py:127"),
    "decode_blocks": ("jpeg_tpu_torch/csrc/decode_blocks.cu",
                      "jpeg_tpu/ops/pallas_kernels.py:73"),
}


def log(*a) -> None:
    print(*a, flush=True)


def synth_image(h: int, w: int, channels: int = 3) -> np.ndarray:
    """Natural-image-like content: smooth structure + texture + mild noise
    (the generator of bench.py, seed 7)."""
    rng = np.random.default_rng(7)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    out = []
    for c in range(channels):
        plane = (128
                 + 70 * np.sin(x / (17 + 6 * c)) * np.cos(y / (23 - 4 * c))
                 + 30 * np.sin((x + y) / (9 + 2 * c))
                 + 8 * rng.standard_normal((h, w)))
        out.append(np.clip(plane, 0, 255))
    return np.stack(out, axis=-1).astype(np.uint8)


def adversarial_levels(n: int, L: int, seed: int = 1) -> np.ndarray:
    """Sparse random levels with the codec's edge cases: bare-EOB blocks,
    +-16383, long zero runs (15, 16, 30, 63), dense blocks."""
    rng = np.random.default_rng(seed)
    lv = np.where(rng.random((n, L)) < 0.15,
                  rng.integers(-300, 301, (n, L)), 0)
    kind = rng.integers(0, 6, n)
    lv[kind == 0] = 0                                       # bare EOB
    dense = kind == 1
    lv[dense] = rng.choice([-16383, 16383, -1, 1, 255], (int(dense.sum()), L))
    for k, run in zip((2, 3, 4), (15, 16, 30)):
        sel = kind == k
        lv[sel] = 0
        lv[sel, run] = rng.integers(1, 16384, int(sel.sum()))
        lv[sel, L - 1] = -16383
    lv[kind == 5, :L - 1] = 0                               # run of 63
    return lv.astype(np.int32)


def time_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` calls after a warm-up."""
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


def median_call_ms(fn, reps: int) -> float:
    """Median CUDA-event time of single host calls that end in a sync."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_diff(a, b) -> int:
    """Largest elementwise |a - b| of two integer tensors, as an int."""
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def nvidia_smi(query: str) -> str:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    log(f"  ok: {what}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import jpeg_tpu_torch  # noqa: F401
    except ModuleNotFoundError as e:
        print(f"chip_smoke: {e}: run it from the root of a checkout of the "
              "repository", file=sys.stderr)
        return 1
    from jpeg_tpu_torch import (Configuration, QuantizationMethod,
                                compress_ycbcr, container,
                                decompress_to_ycbcr, psnr)
    from jpeg_tpu_torch.entropy import device_codec as DC
    from jpeg_tpu_torch.entropy import native_codec
    from jpeg_tpu_torch.ops import kernels as K
    from jpeg_tpu_torch.ops.band import BandDecoder, BandEncoder
    from jpeg_tpu_torch.ops.blocks import crop, deblockify
    from jpeg_tpu_torch.utils import parity

    dev = torch.device("cuda", 0)
    card = nvidia_smi("name,power.limit")
    log(f"== phase 1: device\n  nvidia-smi: {card}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    log("== phase 2: build")
    t0 = time.perf_counter()
    so = K.build()
    K._library()
    log(f"  built {os.path.relpath(so)} in {time.perf_counter() - t0:.1f} s")
    with open(os.path.join(os.path.dirname(so), "build.log")) as f:
        for line in f:
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("  ptxas: " + line.strip())
    check(native_codec.available(), "host C++ entropy codec built")

    def cfg_for(h, w):
        return Configuration(width=w, height=h, block_size=2, dct_size=8,
                             quantization=QuantizationMethod("qtable"))

    log("== phase 3: kernels vs plain versions at the main path's shapes")
    h, w = SIZES[0]
    cfg = cfg_for(h, w)
    img = synth_image(h, w)
    img_t = torch.from_numpy(img).to(dev).permute(2, 0, 1)
    flat = BandEncoder(cfg).to(dev)(img_t).reshape(-1, 64)     # (3N, L)
    L = flat.shape[1]
    n_blocks = flat.shape[0]
    log(f"  levels: {tuple(flat.shape)} from a {h}x{w} image")

    def entropy_kernels(label, lv):
        """K1-K3 vs their plain versions (bit-equal) and the host codec;
        returns the timing closures on these inputs."""
        W = -(-int(DC.block_bytes_of(lv).max()) // 4)
        rows_k, bb_k = K.encode_stream_rows(lv, W)
        rows_p, bb_p = K.encode_stream_rows_plain(lv, W)
        check(torch.equal(rows_k, rows_p) and torch.equal(bb_k, bb_p),
              f"K1 {label}: rows and block bytes bit-equal (W={W})")
        total = int(bb_k.to(torch.int64).sum())
        buf_k = K.deposit_rows(rows_k, bb_k, total)
        buf_p = K.deposit_rows_plain(rows_p, bb_p, total)
        check(torch.equal(buf_k, buf_p), f"K2 {label}: stream bit-equal "
              f"({total} bytes)")
        want = native_codec.encode_levels(lv.cpu().numpy())
        check(buf_k.cpu().numpy().tobytes() == want,
              f"K1+K2 {label}: stream equals the host C++ encoder's")
        starts = torch.cumsum(bb_k.to(torch.int64), 0) - bb_k.to(torch.int64)
        dec_k = K.decode_stream_blocks(buf_k, starts, L)
        dec_p = K.decode_stream_blocks_plain(buf_k, starts, L)
        check(torch.equal(dec_k, dec_p) and torch.equal(dec_k, lv),
              f"K3 {label}: levels bit-equal to plain and to the input")
        return {
            "encode_stream_rows": dict(
                err=max(max_diff(rows_k, rows_p), max_diff(bb_k, bb_p)),
                fn=lambda: K.encode_stream_rows(lv, W),
                plain=lambda: K.encode_stream_rows_plain(lv, W)),
            "deposit_rows": dict(
                err=max_diff(buf_k, buf_p),
                fn=lambda: K.deposit_rows(rows_k, bb_k, total),
                plain=lambda: K.deposit_rows_plain(rows_k, bb_k, total)),
            "decode_stream_blocks": dict(
                err=max_diff(dec_k, dec_p),
                fn=lambda: K.decode_stream_blocks(buf_k, starts, L),
                plain=lambda: K.decode_stream_blocks_plain(buf_k, starts, L)),
        }

    results = entropy_kernels("image", flat)
    entropy_kernels("adversarial",
                    torch.from_numpy(adversarial_levels(n_blocks, L)).to(dev))

    dec = BandDecoder(cfg).to(dev)
    pix_k = K.decode_blocks(flat, dec.op_t, dec.deq)
    pix_p = K.decode_blocks_plain(flat, dec.op_t, dec.deq)
    nv, nh, D = cfg.blocks_high, cfg.blocks_wide, dec.D

    def planes(pix):
        planes3 = deblockify(pix.reshape(3, nv, nh, D, D))
        return crop(planes3, h, w).cpu().numpy()

    got, want_p = planes(pix_k), planes(pix_p)
    flat_np = flat.cpu().numpy().reshape(3, -1, L)
    for b in range(3):
        ref, ties = parity.decode_reference_and_ties(cfg, flat_np[b])
        parity.assert_tie_equal(got[b], want_p[b], ties,
                                f"K4 vs plain band {b}")
        parity.assert_tie_equal(got[b], ref, ties, f"K4 vs f64 band {b}")
    k4_err = int(np.abs(got.astype(np.int64) - want_p).max())  # 0 or 1
    check(True, f"K4: equal to plain and to the f64 reference except +-1 at "
          f"ties (max |diff| vs plain {k4_err}, "
          f"{int((got != want_p).sum())} tie flips)")
    results["decode_blocks"] = dict(
        err=k4_err, fn=lambda: K.decode_blocks(flat, dec.op_t, dec.deq),
        plain=lambda: K.decode_blocks_plain(flat, dec.op_t, dec.deq))

    log("== phase 4: main path (compress_ycbcr -> decompress_to_ycbcr)")
    images = {hw: synth_image(*hw) for hw in SIZES}
    runs = {}
    K.reset_launch_counts()
    for hw, im in images.items():
        blob = compress_ycbcr(im, cfg_for(*hw))
        runs[hw] = (blob, decompress_to_ycbcr(blob))
    counts = K.launch_counts()
    log(f"  launch counts over the main-path run: {counts}")
    check(all(counts[name] > 0 for name in KERNEL_INFO),
          "every kernel of the path was launched")
    for (h, w), (blob, rec) in runs.items():
        cfg = cfg_for(h, w)
        im = images[(h, w)]
        log(f"  -- {h}x{w}: {len(blob)} bytes "
            f"({im.nbytes / len(blob):.2f}x)")
        cfg2, data = container.read_data(blob)
        streams = [data.y, data.cb, data.cr]
        check(cfg2 == cfg and len(container.create_header(cfg)) + 12
              + sum(map(len, streams)) == len(blob), "container re-parses")
        img_t = torch.from_numpy(im).to(dev).permute(2, 0, 1)
        lv = BandEncoder(cfg).to(dev)(img_t).cpu().numpy()     # (3, N, L)
        for b in range(3):
            check(native_codec.encode_levels(lv[b]) == streams[b],
                  f"band {b} stream byte-equal to the host C++ encoder's")
            ref, ties = parity.encode_reference_and_ties(cfg, im[:, :, b])
            parity.assert_tie_equal(lv[b], ref, ties, f"levels band {b}")
        check(True, "levels equal the f64 reference except +-1 at ties")
        p = psnr(im, rec)
        check(rec.shape == im.shape and rec.dtype == np.uint8
              and p > PSNR_MIN_DB, f"decoded {rec.shape} uint8, PSNR "
              f"{p:.2f} dB > {PSNR_MIN_DB}")
        # the plain-version decode path on the card
        nb = cfg.num_blocks
        buf = b"".join(streams)
        stream = torch.frombuffer(bytearray(buf), dtype=torch.uint8).to(dev)
        off = np.cumsum([0] + [len(s) for s in streams[:2]])
        starts = torch.from_numpy(np.concatenate(
            [native_codec.scan_offsets(s, nb, 64).astype(np.int64) + o
             for s, o in zip(streams, off)])).to(dev)
        lv_p = K.decode_stream_blocks_plain(stream, starts, 64)
        bd = BandDecoder(cfg).to(dev)
        pix = K.decode_blocks_plain(lv_p, bd.op_t, bd.deq)
        plain = crop(deblockify(pix.reshape(3, cfg.blocks_high,
                                            cfg.blocks_wide, bd.D, bd.D)),
                     h, w).cpu().numpy()
        for b in range(3):
            _, ties = parity.decode_reference_and_ties(cfg, lv[b])
            parity.assert_tie_equal(rec[:, :, b], plain[b], ties,
                                    f"planes vs plain path band {b}")
        check(True, "planes equal the plain-version path's except +-1 at "
              f"ties ({int((rec.transpose(2, 0, 1) != plain).sum())} flips)")

    log("  -- the caller's TF32 settings")
    (h, w), (blob, _) = next(iter(runs.items()))
    matmul = torch.backends.cuda.matmul
    for label, set_tf32 in (
            ("set_float32_matmul_precision('high')",
             lambda: torch.set_float32_matmul_precision("high")),
            ("cuda.matmul.fp32_precision = 'tf32'",
             lambda: setattr(matmul, "fp32_precision", "tf32"))):
        set_tf32()
        try:
            blob_tf32 = compress_ycbcr(images[(h, w)], cfg_for(h, w))
            left = matmul.fp32_precision
        finally:
            torch.set_float32_matmul_precision("highest")
            matmul.fp32_precision = "none"
        check(blob_tf32 == blob and left == "tf32",
              f"after {label}: the {h}x{w} container is the same bytes "
              "(full f32 products) and the caller's setting is left on")

    log(f"== phase 5: timing (CUDA events; {card})")
    for (h, w), (blob, _) in runs.items():
        cfg = cfg_for(h, w)
        im = images[(h, w)]
        enc = median_call_ms(lambda: compress_ycbcr(im, cfg), REPS)
        dec_ms = median_call_ms(lambda: decompress_to_ycbcr(blob), REPS)
        mp = h * w / 1e6
        log(f"  encode {h}x{w}: {enc:.3f} ms median of {REPS} "
            f"= {mp / enc * 1e3:.1f} MP/s  [{card}]")
        log(f"  decode {h}x{w}: {dec_ms:.3f} ms median of {REPS} "
            f"= {mp / dec_ms * 1e3:.1f} MP/s  [{card}]")
    kernels = []
    for name, r in results.items():
        ms = time_ms(r["fn"], 50)
        plain_ms = time_ms(r["plain"], 5)
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
            f"(N={n_blocks}, L={L})  [{card}]")
        src, repl = KERNEL_INFO[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": repl, "launches": counts[name],
                        "max_abs_err": r["err"], "ms": ms,
                        "plain_ms": plain_ms})
    log("  after timing: " + nvidia_smi(
        "clocks.sm,power.draw,power.limit,temperature.gpu"))

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
