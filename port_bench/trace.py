"""The traced run: torch.profiler over the measured window, host-clock spans
recorded from the benchmark's own wrappers, and their reduction.

The profiler's events are read in memory; nothing is written to disk.
Device events are kernels, copies (``Memcpy ...``) and fills
(``Memset ...``), and not the annotations that mirror host ranges; the
window is the profiler's own ``port_bench.window``
range, so both sides of every interval are on the profiler's clock.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch

WINDOW = "port_bench.window"


class Spans:
    """Host-clock spans by name, from any thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self.by_name: Dict[str, List[float]] = defaultdict(list)

    def add(self, name: str, t0: float, t1: float) -> None:
        with self._lock:
            self.by_name[name].append(t1 - t0)

    @contextlib.contextmanager
    def span(self, name: str):
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.add(name, t0, time.perf_counter())


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    kernel_s: float
    copy_s: float
    ops: List[Tuple[str, float]]          # (name, seconds), longest first
    idle: List[Tuple[str, float]]         # (host activity, idle seconds)


def profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "fill"
    return "kernel"


def _events(prof):
    """(name, on the device, start us, end us, is an annotation) of every
    event, from the profiler's raw results where this torch has them (the
    parsed ``prof.events()`` takes about 70 times longer)."""
    cuda = torch.autograd.DeviceType.CUDA
    raw = getattr(prof.profiler, "kineto_results", None)
    if raw is not None:
        for ev in raw.events():
            yield (ev.name(), ev.device_type() == cuda, ev.start_ns() / 1e3,
                   ev.end_ns() / 1e3, ev.is_user_annotation())
        return
    for ev in prof.events():
        yield (ev.name, ev.device_type == cuda, ev.time_range.start,
               ev.time_range.end, getattr(ev, "is_user_annotation", False))


def reduce(prof, top: int = 10, labelled_gaps: int = 2000) -> DeviceTrace:
    """Busy and idle time of the device inside the window, kernel and copy
    time, the device operations that took most time, and the device's idle
    time by what the host was doing at each gap's midpoint (the shortest
    host event that covers it)."""
    dev_iv, cpu_iv = [], []
    win = None
    for name, dev, start, end, note in _events(prof):
        if dev:
            # A record_function range is mirrored on the device's timeline
            # as an annotation: it is no device work.
            if not note:
                dev_iv.append((start, end, name))
        else:
            if name == WINDOW:
                win = (start, end)
            cpu_iv.append((start, end, name))
    if win is None:
        raise RuntimeError(f"the profiler holds no {WINDOW!r} range")
    w0, w1 = win
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in dev_iv
              if e > w0 and s < w1]
    per_op = defaultdict(float)
    kernel = copy = 0.0
    for s, e, n in inside:
        per_op[n] += e - s
        if _kind(n) == "kernel":
            kernel += e - s
        elif _kind(n) == "copy":
            copy += e - s
    # Union of the device intervals, and the gaps between them.
    merged = []
    for s, e, _ in sorted(inside):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = defaultdict(float)
    if cpu_iv:
        cs = np.array([c[0] for c in cpu_iv], dtype=np.float64)
        ce = np.array([c[1] for c in cpu_iv], dtype=np.float64)
        dur = ce - cs
        for a, b in gaps[:labelled_gaps]:
            m = 0.5 * (a + b)
            cover = np.nonzero((cs <= m) & (ce >= m))[0]
            label = (cpu_iv[cover[np.argmin(dur[cover])]][2] if cover.size
                     else "(no host event)")
            idle[label] += (b - a) * 1e-6
    rest = sum(b - a for a, b in gaps[labelled_gaps:]) * 1e-6
    if rest > 0:
        idle["(shorter gaps)"] += rest
    ops = sorted(((n, t * 1e-6) for n, t in per_op.items()),
                 key=lambda x: -x[1])[:top]
    idle_top = sorted(idle.items(), key=lambda x: -x[1])[:top]
    return DeviceTrace((w1 - w0) * 1e-6, busy * 1e-6, kernel * 1e-6,
                       copy * 1e-6, ops, idle_top)
