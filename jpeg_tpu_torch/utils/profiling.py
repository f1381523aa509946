"""Tracing, timing and metrics.

Counterpart of ``jpeg_tpu/utils/profiling.py``:

* :class:`StageTimer`: wall-clock time per named stage.  Values fenced on
  the stage are waited for at its exit (the CUDA devices of their tensors
  are synchronized), so the stage includes the device work it launched.
* :func:`trace`: a ``torch.profiler`` scope that writes a Chrome / Perfetto
  trace (JSON) into a directory when one is given.
* :class:`Metrics`: the BASELINE.md metric set (megapixels/s, compressed
  bytes, compression ratio, PSNR) with one-line JSON reporting.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional

import torch


def _cuda_devices(value, out: set) -> set:
    """The CUDA devices of every tensor in ``value``, which may nest
    tuples, lists and dicts."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, out)
    return out


class _StageScope:
    """Collects the values a stage must wait for at its exit."""

    def __init__(self) -> None:
        self._pending = []

    def fence(self, value):
        """Mark value(s) whose device work this stage must include."""
        self._pending.append(value)
        return value


class StageTimer:
    """Accumulates wall time per named stage.

    Fence the stage's device outputs on the yielded scope, so the stage
    includes their execution (kernel launches return before the device
    finishes):

    >>> t = StageTimer()
    >>> with t.stage("dct") as s:
    ...     out = s.fence(fn(x))   # its device synchronized at stage exit
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[_StageScope]:
        scope = _StageScope()
        t0 = time.perf_counter()
        try:
            yield scope
        finally:
            for dev in _cuda_devices(scope._pending, set()):
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, float]:
        return {k: round(v, 6) for k, v in
                sorted(self.totals.items(), key=lambda kv: -kv[1])}

    def __str__(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = [f"{k:>24s}: {v * 1e3:9.2f} ms ({100 * v / total:5.1f}%) "
                 f"x{self.counts[k]}"
                 for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])]
        return "\n".join(lines)


@contextlib.contextmanager
def trace(outdir: Optional[str]) -> Iterator[None]:
    """``torch.profiler`` scope writing ``outdir/trace_<pid>_<ms>.json``
    (Chrome / Perfetto format) at exit; a no-op when ``outdir`` is falsy.
    Records host activity, and the device's where CUDA is available."""
    if not outdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(outdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        outdir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))


@dataclass
class Metrics:
    """Per-run codec metrics (BASELINE.md metric set)."""

    images: int = 0
    pixels: int = 0
    raw_bytes: int = 0
    compressed_bytes: int = 0
    seconds: float = 0.0
    failures: int = 0
    psnr_sum: float = 0.0
    psnr_count: int = 0
    extra: Dict[str, float] = field(default_factory=dict)

    def add_image(self, h: int, w: int, nbytes: int, seconds: float,
                  psnr: Optional[float] = None) -> None:
        self.images += 1
        self.pixels += h * w
        self.raw_bytes += h * w * 3
        self.compressed_bytes += nbytes
        self.seconds += seconds
        if psnr is not None:
            self.psnr_sum += psnr
            self.psnr_count += 1

    @property
    def megapixels_per_s(self) -> float:
        return self.pixels / self.seconds / 1e6 if self.seconds else 0.0

    @property
    def compression_ratio(self) -> float:
        return (self.raw_bytes / self.compressed_bytes
                if self.compressed_bytes else 0.0)

    def to_dict(self) -> Dict[str, float]:
        d = {
            "images": self.images,
            "megapixels": round(self.pixels / 1e6, 3),
            "seconds": round(self.seconds, 3),
            "megapixels_per_s": round(self.megapixels_per_s, 3),
            "compressed_bytes": self.compressed_bytes,
            "compression_ratio": round(self.compression_ratio, 2),
            "failures": self.failures,
        }
        if self.psnr_count:
            d["mean_psnr_db"] = round(self.psnr_sum / self.psnr_count, 2)
        d.update(self.extra)
        return d

    def json_line(self) -> str:
        return json.dumps(self.to_dict())
