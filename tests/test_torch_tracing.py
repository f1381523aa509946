"""The port's span recorder (``jpeg_tpu_torch/utils/profiling.py``) and the
spans and counters placed in its decode path.

* Each decode entry, under both scan policies, records one root span a
  call with its own request id, and children that carry their parent's
  id, the host scan's on the pool threads and the pull on the puller
  thread included; with the band modules' cache cleared, the first
  module counts ``band.builds`` inside one ``band.build`` span and every
  later one ``band.cache_hits``; a pull past the pinned answers' bound
  counts ``decode.pull_pageable``; a kernel-branch decode at bs > 1 counts
  ``band.inflate_store``.
* Off, ``span`` returns one shared object and nothing is recorded; the
  answers are bit-identical on and off.
* Under a CPU ``torch.profiler`` session every span of the thread the
  session records is a host range nested in its parent's; spans on pool
  threads, which the session does not record, open no range.
* Starts and stops nest; counters and spans survive many threads.
* The benchmark's eight readers of the recorder give a value in a traced
  run of each cell's tiny copy, and nothing where the program has no
  recorder.
"""
import collections
import importlib.util
import math
import os
import sys
import threading
import types

import numpy as np
import pytest
import torch

import jpeg_tpu_torch as J
from jpeg_tpu_torch import api
from jpeg_tpu_torch.ops import band
from jpeg_tpu_torch.ops.band import BandDecoder
from jpeg_tpu_torch.utils import profiling as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRIES = ("decompress_to_ycbcr", "decompress_to_device", "decompress_many")
SCANS = ("host", "device")
MANY = 3
READERS = ("host_busy_ms", "device_wait_ms", "parse_ms", "upload_ms",
           "band_operator_ms", "band_upload_ms", "band_builds",
           "boundary_scan_ms")
CELLS = {"d24_4k.decode_single": "latency",
         "cli4k.decode_to_device": "to_device"}


@pytest.fixture(autouse=True)
def _no_recording_left_on():
    """Every test starts and ends with recording off."""
    assert not P._RECORDER.on
    yield
    while P._RECORDER.depth:
        P.stop_recording()


@pytest.fixture(scope="module")
def blob():
    cfg = J.Configuration(width=40, height=24, block_size=2, dct_size=8,
                          transform="DCT",
                          quantization=J.QuantizationMethod("qtable"))
    rng = np.random.default_rng(16)
    img = rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)
    return J.compress_ycbcr(img, cfg, device="cpu")


def _call(entry, blob, scan):
    """One call of ``entry``, its answers as host arrays."""
    if entry == "decompress_many":
        return J.decompress_many([blob] * MANY, device="cpu", scan=scan)
    fn = getattr(J, entry)
    out = fn(blob, device="cpu", scan=scan)
    return [out.numpy() if isinstance(out, torch.Tensor) else out]


def _recorded_call(entry, blob, scan):
    band._CACHE.clear()
    P.start_recording()
    try:
        out = _call(entry, blob, scan)
    finally:
        P.stop_recording()
    return out, P.recorded()


def _expected(entry, scan, blob, pageable=False):
    """The span names one call records, with their numbers, and its
    counters, the band modules' cache cleared before it: the first module
    builds, the others find its buffers; each decode's K4 (bs 2) inflates
    as it stores and moves ``blob``'s band bytes to the device.
    ``pageable``: every pull found the pinned answers' bound full and took
    the pageable path."""
    one = collections.Counter({"decode.parse": 1})
    if scan == "host":
        one.update({"decode.upload": 2, "scan.host": 3})
    else:
        one.update({"decode.upload": 1, "scan.device": 1, "decode.check": 1})
    if entry != "decompress_to_device":
        one["decode.pull"] += 1
    n = MANY if entry == "decompress_many" else 1
    want = collections.Counter({k: v * n for k, v in one.items()})
    want["decode"] = 1
    want["band.build"] = 1
    band_bytes = sum(m for _, m in J.container.read_band_spans(blob)[1])
    counts = {"band.builds": 1, "band.inflate_store": n,
              "decode.stream_bytes": n * band_bytes}
    if n > 1:
        counts["band.cache_hits"] = n - 1
    if pageable and one["decode.pull"]:
        counts["decode.pull_pageable"] = n
    return want, counts


@pytest.mark.parametrize("scan", SCANS)
@pytest.mark.parametrize("entry", ENTRIES)
def test_decode_records_its_span_tree(blob, entry, scan):
    _, rec = _recorded_call(entry, blob, scan)
    want, counts = _expected(entry, scan, blob)
    assert collections.Counter(s.name for s in rec.spans) == want
    root, = [s for s in rec.spans if s.parent is None]
    assert root.name == "decode" and root.request == root.id
    for s in rec.spans:
        if s is root:
            continue
        # Every child, on the caller's thread or a pool's, is the root's
        # and lies inside it.
        assert (s.parent, s.request) == (root.id, root.id), s
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns, s
    assert len({s.id for s in rec.spans}) == len(rec.spans)
    assert rec.counts == counts


@pytest.mark.parametrize("scan", SCANS)
@pytest.mark.parametrize("entry", ENTRIES)
def test_a_pull_past_the_pinned_bound_is_counted(blob, entry, scan,
                                                 monkeypatch):
    """CPU tensors stand in for pinned blocks and the bound is 0: each pull
    is pageable, counts ``decode.pull_pageable`` and records the span tree
    of a pull within the bound."""
    monkeypatch.setattr(api, "_pinned_empty", lambda planes: torch.empty(
        planes.shape, dtype=torch.uint8))
    monkeypatch.setattr(api, "_PINNED_ANSWER_BYTES", 0)
    _, rec = _recorded_call(entry, blob, scan)
    want, counts = _expected(entry, scan, blob, pageable=True)
    assert collections.Counter(s.name for s in rec.spans) == want
    assert rec.counts == counts
    assert api._PINNED.held == 0


@pytest.mark.parametrize("bs,quant,want", [
    (1, ("qtable", {}), 0), (2, ("qtable", {}), 1), (4, ("none", {}), 1),
    (3, ("divide", {"divisor": 40}), 1), (2, ("divide", {"divisor": 2.5}), 0)])
def test_inflate_store_counts_each_kernel_decode_above_bs_1(bs, quant, want):
    """``band.inflate_store`` counts one a ``decompress_to_ycbcr`` whose
    band decoder takes the kernel branch at bs > 1 (K4 writes each pixel to
    its bs x bs places), none at bs 1 or off the kernel branch (a
    non-integer divisor: the chain branch)."""
    cfg = J.Configuration(width=8 * bs * 3 + 1, height=8 * bs * 2,
                          block_size=bs, dct_size=8, transform="DCT",
                          quantization=J.QuantizationMethod(quant[0],
                                                            **quant[1]))
    rng = np.random.default_rng(bs)
    img = rng.integers(0, 256, (cfg.height, cfg.width, 3), dtype=np.uint8)
    blob = J.compress_ycbcr(img, cfg, device="cpu")
    P.start_recording()
    try:
        J.decompress_to_ycbcr(blob, device="cpu", scan="host")
    finally:
        P.stop_recording()
    assert P.recorded().counts.get("band.inflate_store", 0) == want


@pytest.mark.parametrize("entry", ENTRIES)
def test_each_call_is_a_request_of_its_own(blob, entry):
    """Two calls in one recording, inside an enclosing span: two roots of
    ``decode``, each its own request, both children of the enclosing one."""
    P.start_recording()
    try:
        with P.span("caller"):
            _call(entry, blob, "host")
            _call(entry, blob, "host")
    finally:
        P.stop_recording()
    rec = P.recorded()
    caller, = [s for s in rec.spans if s.name == "caller"]
    roots = [s for s in rec.spans if s.name == "decode"]
    assert len(roots) == 2
    for r in roots:
        assert r.parent == caller.id and r.request == r.id != caller.request
        kids = [s for s in rec.spans if s.parent == r.id]
        assert kids and all(s.request == r.id for s in kids)


def test_recording_off_is_one_shared_object(blob):
    P.start_recording()
    P.stop_recording()
    assert P.recorded().spans == () and P.recorded().counts == {}
    first = P.span("decode")
    assert P.span("band.build") is first
    assert P.span("x", request=True) is first
    with first:
        with P.span("inner"):
            P.count("band.builds", 5)
    for entry in ENTRIES:
        for scan in SCANS:
            _call(entry, blob, scan)
    BandDecoder(J.get_header(blob)).to("cpu")
    assert P.recorded().spans == () and P.recorded().counts == {}


@pytest.mark.parametrize("scan", SCANS)
@pytest.mark.parametrize("entry", ENTRIES)
def test_answers_equal_with_recording_on_and_off(blob, entry, scan):
    off = _call(entry, blob, scan)
    on, rec = _recorded_call(entry, blob, scan)
    assert rec.spans
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _profiled(entry, blob, scan):
    P.start_recording()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _call(entry, blob, scan)
    finally:
        P.stop_recording()
    return prof, P.recorded()


# The spans each entry runs on another thread than the caller's.
POOLED = {"decompress_to_ycbcr": {"scan.host"},
          "decompress_to_device": {"scan.host"},
          "decompress_many": {"scan.host", "decode.pull", "decode.check"}}


@pytest.mark.parametrize("scan", SCANS)
@pytest.mark.parametrize("entry", ENTRIES)
def test_spans_are_nested_host_ranges_on_the_profiler(blob, entry, scan):
    prof, rec = _profiled(entry, blob, scan)
    mine = [s for s in rec.spans if s.name not in POOLED[entry]]
    by_id = {s.id: s for s in rec.spans}
    parent_of = {s.name: by_id[s.parent].name for s in mine
                 if s.parent is not None}
    names = {s.name for s in rec.spans}
    events = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events() if e.name in names]
    got = collections.Counter(n for n, _, _ in events)
    assert got == collections.Counter(s.name for s in mine)
    for name, t0, t1 in events:
        if name not in parent_of:
            continue
        assert any(n == parent_of[name] and u0 <= t0 <= t1 <= u1
                   for n, u0, u1 in events), (name, t0, t1)


def test_no_profiler_range_without_a_session(blob, monkeypatch):
    """Recording alone opens no ``record_function``."""
    opened = []
    real = torch.profiler.record_function

    def spy(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    _recorded_call("decompress_to_ycbcr", blob, "host")
    assert opened == []
    _profiled("decompress_to_ycbcr", blob, "host")
    assert "decode" in opened and "decode.pull" in opened
    assert "scan.host" not in opened        # the pool's threads


def test_start_and_stop_nest():
    with pytest.raises(RuntimeError):
        P.stop_recording()
    P.start_recording()
    with P.span("a"):
        P.count("n")
    P.stop_recording()
    assert [s.name for s in P.recorded().spans] == ["a"]
    # The first start clears; an inner start does not.
    P.start_recording()
    assert P.recorded().spans == ()
    with P.span("b"):
        pass
    P.start_recording()
    with P.span("c"):
        P.count("n", 2)
    P.stop_recording()
    assert P._RECORDER.on
    with P.span("d"):
        pass
    P.stop_recording()
    assert not P._RECORDER.on
    rec = P.recorded()
    assert [s.name for s in rec.spans] == ["b", "c", "d"]
    assert rec.counts == {"n": 2}
    # Readable after the last stop, until the next start.
    with P.span("e"):
        P.count("n")
    assert P.recorded() == rec
    assert rec.seconds("b", "c") == sum(
        s.end_ns - s.start_ns for s in rec.spans[:2]) * 1e-9


def test_stage_timer_stages_are_spans():
    t = P.StageTimer()
    P.start_recording()
    try:
        with P.span("outer"):
            with t.stage("x") as s:
                s.fence(torch.ones(2))
                with P.span("inner"):
                    pass
    finally:
        P.stop_recording()
    outer, x, inner = (next(s for s in P.recorded().spans if s.name == n)
                       for n in ("outer", "x", "inner"))
    assert x.parent == outer.id and inner.parent == x.id
    assert inner.request == x.request == outer.id
    assert t.counts == {"x": 1}
    assert t.totals["x"] == pytest.approx((x.end_ns - x.start_ns) * 1e-9)


def test_carry_gives_other_threads_the_callers_span():
    seen = []

    def work(i):
        with P.span(f"w{i}"):
            seen.append(i)

    P.start_recording()
    try:
        with P.span("main"):
            ts = [threading.Thread(target=P.carry(work), args=(i,))
                  for i in range(4)]
            ts += [threading.Thread(target=work, args=(9,))]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in ts)
    finally:
        P.stop_recording()
    rec = P.recorded()
    main, = [s for s in rec.spans if s.name == "main"]
    for s in rec.spans:
        if s.name in ("w0", "w1", "w2", "w3"):
            assert (s.parent, s.request) == (main.id, main.id)
    w9, = [s for s in rec.spans if s.name == "w9"]
    assert w9.parent is None and w9.request == w9.id
    assert sorted(seen) == [0, 1, 2, 3, 9]


def test_counts_and_spans_from_many_threads():
    """More threads than cores and a short switch interval: no count and
    no span is lost, and every id is unique."""
    threads, per = 4 * (os.cpu_count() or 1) + 3, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    P.start_recording()
    try:
        def work():
            for _ in range(per):
                with P.span("s"):
                    P.count("c")
                    P.count("d", 2)

        ts = [threading.Thread(target=P.carry(work)) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
    finally:
        P.stop_recording()
        sys.setswitchinterval(old)
    rec = P.recorded()
    assert rec.counts == {"c": threads * per, "d": 2 * threads * per}
    assert len(rec.spans) == threads * per
    assert len({s.id for s in rec.spans}) == threads * per


# ---------------------------------------------------------------------------
# The benchmark's readers of the recorder
# ---------------------------------------------------------------------------

def _bench_conftest():
    """``port_bench/tests/conftest.py`` (``make_tiny_root``), loaded under
    a name of its own beside this suite's ``conftest``."""
    spec = importlib.util.spec_from_file_location(
        "port_bench_tests_conftest",
        os.path.join(REPO, "port_bench", "tests", "conftest.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    """One traced CPU run of each cell's tiny copy."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from port_bench import harness
    root = str(tmp_path_factory.mktemp("tiny_checkout"))
    _bench_conftest().make_tiny_root(root)
    return {cell: harness.execute(root, cell, 2 ** 31 + 1601, 0.3, True,
                                  "cpu")
            for cell in CELLS}


@pytest.mark.parametrize("reader", READERS)
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_reader_reports_in_a_traced_tiny_run(tiny_runs, cell, reader):
    r = tiny_runs[cell]
    assert r["correct"] is True and r["failed"] == 0
    got = r["metrics"][f"{reader}.{CELLS[cell]}"]
    assert got["value"] is not None and math.isfinite(got["value"])
    assert got["value"] >= 0
    if reader == "band_builds":
        # The warm calls built every module's buffers; the window's hit.
        assert got["value"] == 0.0 and got["unit"] == "builds"
    else:
        assert got["unit"] == "ms"
    if reader in ("band_operator_ms", "band_upload_ms"):
        assert got["value"] == 0.0
    # The benchmark's wrapper of the API's ``BandDecoder(...).to`` reads
    # nothing: the API builds its modules on their device, with no ``.to``.
    assert f"band_build_ms.{CELLS[cell]}" not in r["metrics"]
    if cell == "d24_4k.decode_single":
        assert r["metrics"]["host_scan_ms.latency"]["value"] > 0


def _reader(name):
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from port_bench import manifest
    return manifest.metric_reader(REPO, f"{name}.latency")


@pytest.mark.parametrize("reader", READERS)
def test_reader_reads_nothing_without_a_recorder(reader, monkeypatch):
    """Against a program whose profiling module has no recorder, a reader
    installs nothing and reads None, and raises neither time."""
    r = _reader(reader)
    monkeypatch.delattr(P, "start_recording")
    undo = r.install(None)
    undo()
    assert r.read(types.SimpleNamespace(answers=3), "x") is None


@pytest.mark.parametrize("reader", READERS)
def test_reader_starts_and_stops_one_recording(reader, blob):
    r = _reader(reader)
    band._CACHE.clear()
    undo = r.install(None)
    assert P._RECORDER.on
    _call("decompress_to_ycbcr", blob, "host")
    _call("decompress_to_device", blob, "device")
    undo()
    assert not P._RECORDER.on
    v = r.read(types.SimpleNamespace(answers=2), "x")
    assert v is not None and v >= 0
    if reader == "band_builds":
        assert v == 0.5             # the first call built, the second hit
    assert r.read(types.SimpleNamespace(answers=0), "x") is None
