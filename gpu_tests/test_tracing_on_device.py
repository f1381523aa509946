"""The decode path's spans on the device's clock: a traced 4K
``decompress_to_device(scan="device")`` on the card.

While a ``torch.profiler`` session runs, the recorder's spans are host
ranges on the profiler's timeline (``jpeg_tpu_torch/utils/profiling.py``).
Launches and kernels are joined by their correlation ids in the session's
Chrome trace:

* the launches of the device scan's kernels (K6 ``scan_walk_kernel``, K8
  ``jump_table_kernel`` / ``chain_kernel``) fall inside ``scan.device``;
* the launches of K3 (``decode_stream_kernel``) and K4
  (``decode_blocks_kernel``) fall inside the call's root span ``decode``
  and outside ``scan.device``;
* ``decode.check`` (the read of the scan's check, which waits for the
  stream) ends after the last kernel the call launched has ended on the
  device.

Torch, numpy, pytest and ``jpeg_tpu_torch`` only; skips without a CUDA
device (``conftest.py``).
"""
import json

import numpy as np
import torch

from jpeg_tpu_torch import (Configuration, QuantizationMethod,
                            compress_ycbcr, decompress_to_device)
from jpeg_tpu_torch.utils import profiling

SCAN_KERNELS = ("scan_walk_kernel", "jump_table_kernel", "chain_kernel")
DECODE_KERNELS = ("decode_stream_kernel", "decode_blocks_kernel")


def _frame(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth structure and noise, as a camera frame has."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    planes = [128 + 80 * np.sin(x / (17 + 9 * c) + c) * np.cos(y / (23 + c))
              + rng.normal(0, 6, (h, w)) for c in range(3)]
    return np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)


def _intervals(events, cat):
    return [(e["name"], e["ts"], e["ts"] + e.get("dur", 0), e)
            for e in events if e.get("cat") == cat and e.get("ph") == "X"]


def _inside(a0, a1, b0, b1):
    return b0 <= a0 and a1 <= b1


def test_decode_spans_on_the_profiler_clock_on_chip(tmp_path):
    cfg = Configuration(width=3840, height=2160, block_size=4, dct_size=8,
                        transform="DCT",
                        quantization=QuantizationMethod("qtable"))
    blob = compress_ycbcr(_frame(2160, 3840, 16), cfg)
    want = decompress_to_device(blob, scan="device")    # builds, warms
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    profiling.start_recording()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            got = decompress_to_device(blob, scan="device")
            torch.cuda.synchronize()
    finally:
        profiling.stop_recording()
    assert torch.equal(got, want)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]

    notes = {}
    for name, t0, t1, _ in _intervals(events, "user_annotation"):
        notes.setdefault(name, []).append((t0, t1))
    (root,), (scan,), (check,) = (notes["decode"], notes["scan.device"],
                                  notes["decode.check"])
    assert _inside(*scan, *root) and _inside(*check, *root)
    rec = profiling.recorded()
    assert {s.name for s in rec.spans} <= set(notes)

    launches = {}
    for cat in ("cuda_runtime", "cuda_driver"):
        for name, t0, t1, e in _intervals(events, cat):
            corr = e.get("args", {}).get("correlation")
            if "aunch" in name and corr is not None:
                launches[corr] = (t0, t1)
    kernels = [(name, t0, t1, e["args"]["correlation"])
               for name, t0, t1, e in _intervals(events, "kernel")]

    def launched(names):
        out = [(n, launches.get(c)) for n, _, _, c in kernels
               if any(k in n for k in names)]
        assert out, f"no kernel named {names} in the trace"
        assert all(t is not None for _, t in out), f"unmatched: {out}"
        return out

    for n, (t0, t1) in launched(SCAN_KERNELS):
        assert _inside(t0, t1, *scan), n
    for n, (t0, t1) in launched(DECODE_KERNELS):
        assert _inside(t0, t1, *root), n
        assert t1 <= scan[0] or t0 >= scan[1], n
    ends = [t1 for _, _, t1, c in kernels
            if c in launches and _inside(*launches[c], *root)]
    assert ends and check[1] >= max(ends)
