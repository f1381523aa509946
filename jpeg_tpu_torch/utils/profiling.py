"""Spans, counters, stage timing and metrics.

Counterpart of ``jpeg_tpu/utils/profiling.py``, with the port's own span
recorder:

* :func:`span` / :func:`count`: named host spans and counters placed in
  the codec where its work happens (container parse, stream upload,
  boundary scan, band module build and move, the waits on the device).
  Off unless :func:`start_recording` was called, and then free: ``span``
  hands back one shared do-nothing context manager and ``count`` tests a
  flag.  While recording, each span keeps its name, start and end
  (``time.perf_counter_ns()``), its own id, its parent's id and the id of
  its request (its root span, or the nearest span opened with
  ``request=True``); :func:`recorded` returns them with the counters.  On
  a thread a ``torch.profiler`` session records, a recorded span is also
  a ``record_function`` range, so it lies on the profiler's timeline
  beside the device's kernels (a default session records the thread that
  started it; a range on another thread would reach no timeline and is
  not opened).  Spans find their parent through a
  ``contextvars.ContextVar``; work handed to another thread keeps its
  parent when it runs through :func:`carry`.
* :class:`StageTimer`: wall-clock time per named stage, each stage one
  span.  Values fenced on the stage are waited for at its exit (the CUDA
  devices of their tensors are synchronized), so the stage includes the
  device work it launched.
* :class:`Metrics`: the BASELINE.md metric set (megapixels/s, compressed
  bytes, compression ratio, PSNR) with one-line JSON reporting.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import itertools
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler


class SpanRecord(NamedTuple):
    """One finished span, times from ``time.perf_counter_ns()``."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]      # the enclosing span's id, None at a root
    request: int               # the id of the span that began the request


@dataclass(frozen=True)
class Recording:
    """The spans and counters of one recording, in the order spans ended."""
    spans: Tuple[SpanRecord, ...]
    counts: Dict[str, int]

    def seconds(self, *names: str) -> float:
        """Summed duration of the spans with any of ``names``."""
        return sum(s.end_ns - s.start_ns for s in self.spans
                   if s.name in names) * 1e-9


class _Recorder:
    """The process's recording state: a depth of nested starts, the spans
    of the current recording and its counters."""

    def __init__(self) -> None:
        self.on = False
        self.depth = 0
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        self.spans: list = []
        self.counts: Dict[str, int] = {}


_RECORDER = _Recorder()
_OPEN: contextvars.ContextVar = contextvars.ContextVar(
    "jpeg_tpu_torch_open_span", default=None)


def start_recording() -> None:
    """Start recording spans and counters.  Starts nest: each needs its
    :func:`stop_recording`, and only the outermost clears the previous
    recording."""
    r = _RECORDER
    with r.lock:
        if r.depth == 0:
            r.spans, r.counts = [], {}
            r.on = True
        r.depth += 1


def stop_recording() -> None:
    """End one :func:`start_recording`; the last one stops the recording,
    whose spans and counters stay readable until the next start."""
    r = _RECORDER
    with r.lock:
        if r.depth == 0:
            raise RuntimeError("stop_recording() without start_recording()")
        r.depth -= 1
        r.on = r.depth > 0


def recorded() -> Recording:
    """The spans and counters of the current or last recording."""
    r = _RECORDER
    with r.lock:
        return Recording(tuple(r.spans), dict(r.counts))


def recording() -> bool:
    """Whether spans and counters are being recorded."""
    return _RECORDER.on


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording."""
    r = _RECORDER
    if r.on:
        with r.lock:
            r.counts[name] = r.counts.get(name, 0) + n


def _profiled_thread() -> bool:
    """Whether a ``torch.profiler`` session records this thread's ranges:
    the module flag first (no session, no call), then the thread's own
    profiler state."""
    return (_autograd_profiler._is_profiler_enabled
            and torch.autograd._profiler_enabled())


class _Span:
    """A timed span.  Entered while recording, it takes an id and its
    parent from the context, is the parent of spans opened inside it, and
    is recorded at its exit (a ``record_function`` range too, on a thread
    a ``torch.profiler`` session records; the span's own time includes
    the range's); otherwise it only reads the clock."""

    __slots__ = ("name", "new_request", "id", "parent", "request",
                 "start_ns", "end_ns", "_sink", "_token", "_range")

    def __init__(self, name: str, new_request: bool = False) -> None:
        self.name = name
        self.new_request = new_request
        self._sink = self._range = None

    def __enter__(self) -> "_Span":
        self.start_ns = time.perf_counter_ns()
        r = _RECORDER
        if r.on:
            self._sink = r.spans
            up = _OPEN.get()
            self.id = next(r.ids)
            self.parent = None if up is None else up.id
            self.request = (self.id if up is None or self.new_request
                            else up.request)
            self._token = _OPEN.set(self)
            if _profiled_thread():
                self._range = torch.profiler.record_function(self.name)
                self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._sink is not None:
            if self._range is not None:
                self._range.__exit__(*exc)
            _OPEN.reset(self._token)
            self.end_ns = time.perf_counter_ns()
            self._sink.append(SpanRecord(self.name, self.start_ns,
                                         self.end_ns, self.id, self.parent,
                                         self.request))
        else:
            self.end_ns = time.perf_counter_ns()

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


_OFF = contextlib.nullcontext()


def span(name: str, *, request: bool = False):
    """A context manager around one piece of the codec's work, recorded
    while recording is on; ``request=True`` makes it the root of a new
    request (one call of the public API).  Off, it is one shared
    do-nothing context manager."""
    if not _RECORDER.on:
        return _OFF
    return _Span(name, request)


def carry(fn):
    """``fn`` bound to a copy of the calling thread's context, to hand to
    another thread: spans it opens there have the caller's open span as
    parent.  Bind once per task; one context cannot run on two threads at
    once."""
    return functools.partial(contextvars.copy_context().run, fn)


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
    """Accumulates wall time per named stage, each stage a span.

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
        """One span named ``name``: recorded like :func:`span`'s while
        recording, timed always."""
        scope = _StageScope()
        sp = _Span(name)
        try:
            with sp:
                try:
                    yield scope
                finally:
                    for dev in _cuda_devices(scope._pending, set()):
                        torch.cuda.synchronize(dev)
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + sp.seconds
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
