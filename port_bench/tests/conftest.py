"""The benchmark's own tests.  Run them from the repository's root:

    python -m pytest port_bench/tests -q

Tests marked ``chip`` need a CUDA device; elsewhere they skip, decided in
a fixture when they run, never while they are collected.
"""
import json
import os
import shutil
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: Frame sizes of the tiny copies of the configurations: padded at both the
#: block size and the transform size, as the full frames are.
TINY = {"cli_default_4k": (54, 70), "divide1000_d24_4k": (100, 136)}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device (skips elsewhere)")


@pytest.fixture(autouse=True)
def _chip_only(request):
    if (request.node.get_closest_marker("chip")
            and not torch.cuda.is_available()):
        pytest.skip("needs a CUDA device: runs the port's kernels at the "
                    "cells' sizes")


def make_tiny_root(path):
    """A checkout-like directory with BENCHMARK.json, every cell's mix as
    it is and its configuration cut to tiny frames, and the metric
    readers."""
    bench = os.path.join(path, "port_bench")
    os.makedirs(os.path.join(bench, "configs"))
    shutil.copytree(os.path.join(ROOT, "port_bench", "metrics"),
                    os.path.join(bench, "metrics"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    for c in manifest["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        cfg["frame"]["height"], cfg["frame"]["width"] = TINY[c["name"]]
        with open(os.path.join(path, c["file"]), "w") as f:
            json.dump(cfg, f)
    shutil.copytree(os.path.join(ROOT, "port_bench", "traffic"),
                    os.path.join(bench, "traffic"))
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    return manifest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny_checkout"))
    make_tiny_root(path)
    return path
