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


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device (skips elsewhere)")


@pytest.fixture(autouse=True)
def _chip_only(request):
    if (request.node.get_closest_marker("chip")
            and not torch.cuda.is_available()):
        pytest.skip("needs a CUDA device: runs the port's kernels at the "
                    "cells' sizes")


def make_tiny_root(path, source=ROOT):
    """A checkout-like directory made from the checkout at ``source``: its
    BENCHMARK.json, every cell's mix as it is, each configuration cut to
    the ``tiny_frame`` its own file gives, and the metric readers."""
    bench = os.path.join(path, "port_bench")
    shutil.copytree(os.path.join(source, "port_bench", "metrics"),
                    os.path.join(bench, "metrics"))
    with open(os.path.join(source, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    for c in manifest["configs"]:
        with open(os.path.join(source, c["file"])) as f:
            cfg = json.load(f)
        if "tiny_frame" not in cfg:
            raise ValueError(f"{c['file']} has no 'tiny_frame': the frame "
                             f"size of the configuration's tiny copy")
        cfg["frame"]["height"] = cfg["tiny_frame"]["height"]
        cfg["frame"]["width"] = cfg["tiny_frame"]["width"]
        dst = os.path.join(path, c["file"])
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        with open(dst, "w") as f:
            json.dump(cfg, f)
    shutil.copytree(os.path.join(source, "port_bench", "traffic"),
                    os.path.join(bench, "traffic"))
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    return manifest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny_checkout"))
    make_tiny_root(path)
    return path
