"""Finds a cell's pieces by name: its entry in BENCHMARK.json, its
configuration file, its traffic mix and the readers of its per-layer
metrics.

Everything that belongs to one configuration, one mix or one metric sits
in files of its own, so a cell made of new files needs no edit here:

* a configuration: the ``file`` its ``configs`` entry names;
* a traffic mix: ``port_bench/traffic/<name>.json``, and, for an entry
  whose arguments the JSON cannot give, a ``<name>.py`` beside it with
  its own ``make_call`` (see ``program.py``);
* a per-layer metric: ``port_bench/metrics/<name>.py``, or, for a metric
  split by the end-to-end metric it moves (``device_idle_pct.encode``), the
  reader of the name before the first dot (``device_idle_pct.py``).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List

BENCH_DIR = "port_bench"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict
    traffic_name: str
    traffic: Dict
    end_to_end: List[Dict]       # the BENCHMARK.json entries this cell reports
    per_layer: List[Dict]


def load_manifest(root: str) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(root: str, name: str, manifest: Dict = None) -> Cell:
    """The cell ``name`` with its configuration and mix loaded; raises
    KeyError for a name BENCHMARK.json does not hold."""
    manifest = manifest or load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    with open(os.path.join(root, cfg["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, BENCH_DIR, "traffic",
                           w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = [m for m in manifest["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if m["moves"] in reported and _reports(m, name)]
    return Cell(name, int(w["chips"]), w["config"], config, w["traffic"],
                traffic, e2e, per_layer)


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(root: str, name: str):
    """The module that reads the per-layer metric ``name``."""
    metrics = os.path.join(root, BENCH_DIR, "metrics")
    for stem in (name, name.split(".")[0]):
        path = os.path.join(metrics, stem + ".py")
        if os.path.exists(path):
            return _load(path, f"port_bench_metric_{stem.replace('.', '_')}")
    raise FileNotFoundError(f"no reader for metric {name!r} under {metrics}")


def mix_code(root: str, traffic: str):
    """The mix's own ``make_call`` module, or None where its JSON says all."""
    path = os.path.join(root, BENCH_DIR, "traffic", traffic + ".py")
    if not os.path.exists(path):
        return None
    return _load(path, f"port_bench_mix_{traffic.replace('.', '_')}")
