#!/usr/bin/env python3
"""Time the two designs of jpeg_tpu_torch's K4 (``decode_blocks``) on one
NVIDIA GPU: the package's tensor-core product (csrc/decode_blocks.cu) and
the register-blocked SIMT design it was chosen over
(benchmarks/k4_simt.cu), beside the plain version and one full-f32
``torch.matmul`` of the same operands.

    python3 benchmarks/torch_k4_designs.py

Builds ``k4_simt.cu`` with ``nvcc`` into ``build/k4_designs/`` and the
package's kernels as the package does; runs on ``chip_smoke.py``'s
synthetic 2048x2048 image (seed 7) at the main path (qtable, DCT, d 8,
bs 2: N = 49,152, K = M = 64) and at BASELINE (3) (divide 1000, d 24,
bs 4: N = 1,452, K = M = 576), on the band decoder's d*d operator, each
pixel stored once (bs 1: the SIMT design has no inflate store).  Both designs must equal the exact
(f64) sums' rounding except +-1 at provable ties.  Times are CUDA events,
mean of 50 launches (plain and matmul: 10), in turns (tensor-core, SIMT,
SIMT, tensor-core).  Prints one line per number and, last, a JSON object
with the card's ``name, power.limit``.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS32 = 2.0 ** -23


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


def within_ties(got, lv, deq, op_t, chunk: int = 512) -> int:
    """Pixels of ``got`` off the exact sums' rounding; raises where one is
    off by more than 1 or away from a provable tie."""
    op64 = op_t.double()
    tol = (lv.shape[1] + 16) * EPS32
    flips = 0
    for i in range(0, lv.shape[0], chunk):
        a = (lv[i:i + chunk] * deq).to(torch.float32).double()
        v = a @ op64
        ties = (v - v.floor() - 0.5).abs() <= tol * (a.abs() @ op64.abs())
        d = (got[i:i + chunk].double() - torch.round(v).clamp(0, 255)).abs()
        if bool(((d > 0) & ~ties).any()) or bool((d > 1).any()):
            raise AssertionError("tie contract violated")
        flips += int((d > 0).sum())
    return flips


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k4_designs: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from jpeg_tpu_torch import Configuration, QuantizationMethod
    from jpeg_tpu_torch.ops import kernels as K
    from jpeg_tpu_torch.ops.band import BandDecoder, BandEncoder
    from jpeg_tpu_torch.utils.device import full_f32_matmul

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    out_dir = os.path.join(REPO, "build", "k4_designs")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libk4_simt.so")
    subprocess.run([K._nvcc(), *K.NVCC_FLAGS, "-shared", "-o", so,
                    os.path.join(REPO, "benchmarks", "k4_simt.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    lib.k4_simt.argtypes = (ctypes.c_void_p,) * 3 + (
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p)
    K.build()
    K._library()
    dev = torch.device("cuda", 0)
    img = torch.from_numpy(synth_image(2048, 2048)).to(dev).permute(2, 0, 1)
    res = {"card": card}
    for name, bs, d, quant in (
            ("main path", 2, 8, QuantizationMethod("qtable")),
            ("d = 24", 4, 24, QuantizationMethod("divide", divisor=1000))):
        cfg = Configuration(width=2048, height=2048, block_size=bs,
                            dct_size=d, quantization=quant)
        lv = BandEncoder(cfg).to(dev)(img).reshape(-1, d * d).contiguous()
        dec = BandDecoder(cfg).to(dev)
        n, L = lv.shape
        M = dec.op_t.shape[1]
        simt_out = torch.empty((n, M), dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def simt():
            err = lib.k4_simt(lv.data_ptr(), dec.deq.data_ptr(),
                              dec.op_t.data_ptr(), n, L, M,
                              simt_out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"k4_simt: CUDA error {err}")

        def tensor_core():
            return K.decode_blocks(lv, dec.op_t, dec.deq)

        a32 = (lv * dec.deq).to(torch.float32)

        def matmul():
            with full_f32_matmul():
                return torch.matmul(a32, dec.op_t)

        simt()
        flips = {"tensor-core": within_ties(tensor_core(), lv, dec.deq,
                                            dec.op_t),
                 "SIMT": within_ties(simt_out, lv, dec.deq, dec.op_t)}
        times = {}
        for label, fn in (("tensor-core", tensor_core), ("SIMT", simt),
                          ("SIMT", simt), ("tensor-core", tensor_core)):
            times.setdefault(label, []).append(mean_ms(fn, 50))
        times["plain"] = [mean_ms(lambda: K.decode_blocks_plain(
            lv, dec.op_t, dec.deq), 10)]
        times["torch.matmul"] = [mean_ms(matmul, 10)]
        shape = f"N={n}, K={L}, M={M}"
        for label, ts in times.items():
            key = f"{name} {label} ms"
            res[key] = ts
            print(f"{key} ({shape}): " + ", ".join(f"{t:.4f}" for t in ts)
                  + (f"; {flips[label]} tie flips" if label in flips else "")
                  + f"  [{card}]", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"torch_k4_designs: {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    sys.exit(rc)
