"""What decides ``correct``: the control (the reference in TF32 in the
program's place) and faults planted under the timed path must come out
not correct; sound runs must come out correct."""
import numpy as np
import pytest
import torch

import jpeg_tpu_torch as jt

from conftest import ROOT

from port_bench import control, harness, manifest

CELLS = [w["name"] for w in manifest.load_manifest(ROOT)["workloads"]]
SEEDS = [11, 2 ** 31 + 12, 2 ** 33 + 13]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(tiny_root, cell, seed):
    prog = control.readings(tiny_root, cell, seed, "program", "cpu")
    ctrl = control.readings(tiny_root, cell, seed, "control", "cpu")
    number = "bad_pixels"
    assert prog[number]["value"] == 0 and prog["missing"]["value"] == 0
    assert ctrl[number]["value"] > ctrl[number]["limit"]


def _flip(answer):
    """The answer altered where it is produced: one byte of a container's
    last band, or one pixel."""
    if isinstance(answer, (bytes, bytearray)):
        b = bytearray(answer)
        b[-2] ^= 0x10
        return bytes(b)
    if isinstance(answer, torch.Tensor):          # (3, H, W) planes
        t = answer.clone()
        t[0, t.shape[1] // 2, t.shape[2] // 2] ^= 0x40
        return t
    a = np.array(answer)
    a[a.shape[0] // 2, a.shape[1] // 2, 0] ^= 0x40
    return a


def _altered(fn):
    def broken(*args, **kwargs):
        out = fn(*args, **kwargs)
        return [_flip(o) for o in out] if isinstance(out, list) else _flip(out)
    return broken


def _stale(fn):
    """A step that returns its state unchanged: every call answers with the
    previous call's answers."""
    last = []

    def broken(*args, **kwargs):
        out = fn(*args, **kwargs)
        last.append(out)
        return last.pop(0) if len(last) > 1 else out
    return broken


FAULTS = {"altered": _altered, "stale": _stale}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(tiny_root, monkeypatch, cell, fault):
    """At the cell's own pool (only the frames are tiny).  Every cell calls
    a single-image entry; a batch's faults are planted in
    test_port_bench_harness.py::test_mix_that_brings_its_own_call."""
    entry = manifest.find_cell(ROOT, cell).traffic["entry"]
    monkeypatch.setattr(jt, entry, FAULTS[fault](getattr(jt, entry)))
    r = harness.execute(tiny_root, cell, 2 ** 31 + 21, 0.3, False, "cpu")
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    r = harness.execute(tiny_root, cell, 2 ** 31 + 22, 0.3, False, "cpu")
    assert r["correct"] is True and r["failed"] == 0, r["checks"]


@pytest.mark.chip
@pytest.mark.parametrize(
    "cell", [w["name"] for w in manifest.load_manifest(ROOT)["workloads"]])
def test_control_fails_at_the_cells_size_on_the_chip(cell):
    for seed in SEEDS:
        prog = control.readings(ROOT, cell, seed, "program", "cuda")
        ctrl = control.readings(ROOT, cell, seed, "control", "cuda")
        number = "bad_pixels"
        assert prog[number]["value"] == 0
        assert ctrl[number]["value"] > ctrl[number]["limit"]
