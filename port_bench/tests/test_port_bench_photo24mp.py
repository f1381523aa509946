"""The ``photo24mp_444`` configuration and the ``stream_upload_gbps`` reader.

* The committed configuration file's tiny copy (its own ``tiny_frame``)
  runs its cell ``correct``, traced and untraced, with every per-layer
  metric of the program's spans and counters in the traced line.
* ``stream_upload_gbps.to_device`` reads a finite rate above 0 in a traced
  tiny run of each to-device cell, and nothing where the program has no
  recorder or counts no stream bytes.
"""
import json
import math
import os
import types

import pytest

from conftest import ROOT

from port_bench import harness, manifest

CELL = "photo24mp_444.decode_to_device"
READER = "stream_upload_gbps.to_device"
TO_DEVICE = [w["name"] for w in manifest.load_manifest(ROOT)["workloads"]
             if w["traffic"] == "decode_to_device"]


def test_configuration_as_the_manifest_names_it():
    m = manifest.load_manifest(ROOT)
    entry, = [c for c in m["configs"] if c["name"] == "photo24mp_444"]
    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = json.load(f)
    assert cfg["codec"] == {"block_size": 1, "dct_size": 8,
                            "transform": "DCT",
                            "quantization": {"name": "qtable", "params": {}},
                            "dtype": "float32"}
    assert (cfg["frame"]["height"], cfg["frame"]["width"]) == (4000, 6000)
    assert cfg["tiny_frame"] == {"height": 44, "width": 60}
    assert cfg["reduced"] == entry["reduced"] == []
    cell = manifest.find_cell(ROOT, CELL)
    assert cell.chips == 1 and cell.traffic_name == "decode_to_device"
    assert [x["name"] for x in cell.end_to_end] == ["decode_to_device_mps",
                                                    "setup_s"]
    assert READER in [x["name"] for x in cell.per_layer]
    assert sorted(TO_DEVICE) == sorted(
        {x["name"]: x for x in m["per_layer"]}[READER]["workloads"])


@pytest.fixture(scope="module")
def runs(tiny_root):
    """A traced run of each to-device cell's tiny copy, and an untraced one
    of the new cell's."""
    got = {(c, True): harness.execute(tiny_root, c, 2 ** 31 + 2401, 0.3,
                                      True, "cpu") for c in TO_DEVICE}
    got[CELL, False] = harness.execute(tiny_root, CELL, 2 ** 33 + 2402, 0.3,
                                       False, "cpu")
    return got


def _sound(r):
    assert r["correct"] is True and r["failed"] == 0, r["checks"]
    assert r["checks"]["bad_pixels"]["value"] == 0
    assert r["checks"]["missing"]["value"] == 0


@pytest.mark.parametrize("traced", [True, False])
def test_tiny_copy_runs_correct(runs, traced):
    r = runs[CELL, traced]
    _sound(r)
    if traced:
        cell = manifest.find_cell(ROOT, CELL)
        program = {x["name"] for x in cell.per_layer
                   if x["source"] in ("program_span", "program_counter")}
        assert program <= set(r["metrics"])
    else:
        assert set(r["metrics"]) == {"decode_to_device_mps", "setup_s"}
        assert r["metrics"]["decode_to_device_mps"]["value"] > 0


@pytest.mark.parametrize("cell", TO_DEVICE)
def test_stream_upload_rate_read_in_each_to_device_cell(runs, cell):
    r = runs[cell, True]
    _sound(r)
    got = r["metrics"][READER]
    assert got["unit"] == "GB/s"
    assert math.isfinite(got["value"]) and got["value"] > 0


def _reader():
    return manifest.metric_reader(ROOT, READER)


def test_stream_upload_rate_reads_nothing_without_a_recorder(monkeypatch):
    from jpeg_tpu_torch.utils import profiling
    r = _reader()
    monkeypatch.delattr(profiling, "start_recording")
    r.install(None)()
    assert r.read(types.SimpleNamespace(answers=3), READER) is None


def test_stream_upload_rate_reads_nothing_without_stream_bytes(monkeypatch):
    """A program that records its spans but counts no stream bytes, as
    before the counter existed, reads None."""
    from jpeg_tpu_torch.utils import profiling
    span = profiling.SpanRecord("decode", 0, 10, 1, None, 1)
    upload = profiling.SpanRecord("decode.upload", 2, 5, 2, 1, 1)
    rec = profiling.Recording((upload, span), {"band.builds": 1})
    monkeypatch.setattr(profiling, "recorded", lambda: rec)
    r = _reader()
    assert r.read(types.SimpleNamespace(answers=1), READER) is None
    with_bytes = profiling.Recording((upload, span),
                                     {"decode.stream_bytes": 3000})
    monkeypatch.setattr(profiling, "recorded", lambda: with_bytes)
    assert r.read(types.SimpleNamespace(answers=1), READER) == \
        pytest.approx(3000 / 3e-9 / 1e9)
