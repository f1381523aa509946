"""The harness: every piece found by name, a cell made of new files only,
the result line, and the runs that must fail."""
import json
import os
import re
import subprocess
import sys

import pytest

from conftest import ROOT, make_tiny_root

from port_bench import harness, manifest, program

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def load():
    return manifest.load_manifest(ROOT)


def test_manifest_keys_and_names():
    m = load()
    assert list(m) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert m["paths"] == ["port_bench"]
    assert m["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= m["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[k]]
    for n in names:
        assert NAME.fullmatch(n), n
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in m[k]}) == len(m[k])
    metrics = m["end_to_end"] + m["per_layer"]
    assert len({x["name"] for x in metrics}) == len(metrics)
    for x in metrics:
        assert UNIT.fullmatch(x["unit"]) and x["better"] in ("lower", "higher")
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25
        assert x["source"] in ("host_clock", "device_trace")
    assert any(x["name"] == "setup_s" for x in m["end_to_end"])
    for x in m["configs"] + m["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
    for x in m["configs"]:
        assert 1 <= len(x["source"]) <= 200
    assert len(json.dumps(m)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in load()["workloads"]])
def test_every_cell_found_by_name(cell):
    m = load()
    c = manifest.find_cell(ROOT, cell)
    entry = {w["name"]: w for w in m["workloads"]}[cell]
    assert c.chips == entry["chips"] == 1
    assert callable(program.entry_of(program.import_program(),
                                     c.traffic["entry"]))
    assert c.traffic["takes"] in ("frames", "containers")
    assert c.traffic["loop"] == "closed"
    codec = harness.codec_of(c.config)
    frame = c.config["frame"]
    assert (codec.height, codec.width) == (frame["height"], frame["width"])
    assert 1 <= codec.height <= 65535 and 1 <= codec.width <= 65535
    cfg = {x["name"]: x for x in m["configs"]}[c.config_name]
    assert c.config["name"] == c.config_name
    assert c.config["reduced"] == cfg["reduced"]
    e2e = [x["name"] for x in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for x in c.end_to_end:
        harness.end_to_end_value(x["name"], 1.0, 10, 1.0, [0.1, 0.2])
    for x in c.per_layer:
        assert callable(manifest.metric_reader(ROOT, x["name"]).read)
        assert x["moves"] in e2e


def test_every_config_file_and_layer_named():
    m = load()
    files = [c["file"] for c in m["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in m["workloads"]}
    for c in m["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("port_bench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    layers = {x["layer"] for x in m["per_layer"]}
    assert all(isinstance(x, str) and x for x in layers)
    assert layers >= {"device", "kernels", "api", "band modules",
                      "boundary scan"}


NEW_CONFIG = {
    "name": "tiny_none", "source": "test", "reduced": [],
    "codec": {"block_size": 2, "dct_size": 4, "transform": "DCT",
              "quantization": {"name": "none", "params": {}},
              "dtype": "float32"},
    "frame": {"height": 18, "width": 26}}
NEW_MIX = {"loop": "closed", "entry": "compress_ycbcr", "takes": "frames",
           "args": ["item", "config", "dtype"], "named": ["device"],
           "pool": 3, "kwargs": {}}
NEW_METRIC = '''
def read(run, name):
    return float(run.answers)
'''


def test_cell_made_of_new_files_runs(tmp_path):
    """A configuration, a mix, a metric and a cell added as new files and
    entries run with no edit to a file that is there."""
    root = str(tmp_path)
    m = make_tiny_root(root)
    bench = os.path.join(root, "port_bench")
    with open(os.path.join(bench, "configs", "tiny_none.json"), "w") as f:
        json.dump(NEW_CONFIG, f)
    with open(os.path.join(bench, "traffic", "single_encode.json"), "w") as f:
        json.dump(NEW_MIX, f)
    with open(os.path.join(bench, "metrics", "answers_seen.py"), "w") as f:
        f.write(NEW_METRIC)
    m["configs"].append({"name": "tiny_none", "source": "test",
                         "file": "port_bench/configs/tiny_none.json",
                         "reduced": [], "why": "test"})
    m["workloads"].append({"name": "tiny.single_encode",
                           "config": "tiny_none", "traffic": "single_encode",
                           "chips": 1, "why": "test"})
    m["end_to_end"].append({"name": "encode_p50_ms", "unit": "ms",
                            "better": "lower", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["tiny.single_encode"]})
    m["per_layer"].append({"name": "answers_seen", "unit": "1",
                           "better": "higher", "source": "program_counter",
                           "layer": "api", "moves": "encode_p50_ms",
                           "workloads": ["tiny.single_encode"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    r0 = harness.execute(root, "tiny.single_encode", 7, 0.2, False, "cpu")
    assert r0["correct"] and set(r0["metrics"]) == {"encode_p50_ms",
                                                    "setup_s"}
    r1 = harness.execute(root, "tiny.single_encode", 7, 0.2, True, "cpu")
    assert r1["correct"]
    assert r1["metrics"]["answers_seen"]["value"] >= 1


def _add_cell(root, m, name, config, traffic, metric):
    m["workloads"].append({"name": name, "config": config,
                           "traffic": traffic, "chips": 1, "why": "test"})
    m["end_to_end"].append({"name": metric, "unit": "MP/s",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock", "workloads": [name]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)


TO_DEVICE_MIX = {"loop": "closed", "entry": "decompress_to_device",
                 "takes": "containers", "args": ["item", "dtype"],
                 "named": ["device"], "pool": 3, "kwargs": {"scan": "auto"}}


def test_mix_of_an_entry_program_does_not_name(tmp_path):
    """A mix, in JSON alone, that drives an entry no file of the benchmark
    names: planes left on the device."""
    root = str(tmp_path)
    m = make_tiny_root(root)
    with open(os.path.join(root, "port_bench", "traffic",
                           "to_device.json"), "w") as f:
        json.dump(TO_DEVICE_MIX, f)
    _add_cell(root, m, "cli4k.to_device", "cli_default_4k", "to_device",
              "device_mps")
    r = harness.execute(root, "cli4k.to_device", 2 ** 32 + 3, 0.2, False,
                        "cpu")
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert set(r["metrics"]) == {"device_mps", "setup_s"}


BATCH_MIX_CODE = '''
def make_call(api, mix, codec, height, width, device):
    import jpeg_tpu_torch.parallel as par
    from port_bench import program
    mesh = par.make_mesh(devices=[device], data=1, band=1)
    dtype = program.dtype_of(codec)

    def call(items):
        return list(par.decompress_batch(items, mesh, dtype,
                                         **mix["kwargs"]))
    return call
'''


BATCH_FAULTS = {
    "none": lambda out: out,
    "reversed": lambda out: out[::-1],           # each answer another's
    "half": lambda out: out[: len(out) // 2],    # half of the batch left out
}


@pytest.mark.parametrize("fault", sorted(BATCH_FAULTS))
def test_mix_that_brings_its_own_call(tmp_path, monkeypatch, fault):
    """A mix whose entry takes a device mesh brings its own make_call in a
    .py beside its JSON; a batch's faults planted under it are caught."""
    import jpeg_tpu_torch.parallel as par
    root = str(tmp_path)
    m = make_tiny_root(root)
    traffic = os.path.join(root, "port_bench", "traffic")
    with open(os.path.join(traffic, "batch_sharded.json"), "w") as f:
        json.dump({"loop": "closed", "entry": "parallel.decompress_batch",
                   "takes": "containers", "batch": 8, "pool": 4,
                   "kwargs": {}}, f)
    with open(os.path.join(traffic, "batch_sharded.py"), "w") as f:
        f.write(BATCH_MIX_CODE)
    _add_cell(root, m, "cli4k.batch_sharded", "cli_default_4k",
              "batch_sharded", "batch_mps")
    orig = par.decompress_batch
    monkeypatch.setattr(par, "decompress_batch",
                        lambda *a, **k: BATCH_FAULTS[fault](orig(*a, **k)))
    r = harness.execute(root, "cli4k.batch_sharded", 5, 0.2, False, "cpu")
    assert r["correct"] is (fault == "none"), r["checks"]


@pytest.mark.parametrize("pool_n,batch", [(8, 32), (8, 1), (3, 5), (1, 4)])
def test_input_stream(pool_n, batch):
    """Consecutive calls differ, no input comes twice in a row, and a chunk
    of a multiple of the pool holds every input equally often."""
    s = harness.input_stream(pool_n, 2 ** 31 + 9)
    calls = [[next(s) for _ in range(batch)] for _ in range(40)]
    flat = [i for c in calls for i in c]
    if pool_n > 1:
        assert all(a != b for a, b in zip(flat, flat[1:]))
    if pool_n > 1 and batch >= pool_n:
        assert len({tuple(c) for c in calls}) > 10
    if batch % pool_n == 0:
        for c in calls:
            assert sorted(c) == sorted(list(range(pool_n)) *
                                       (batch // pool_n))
    again = harness.input_stream(pool_n, 2 ** 31 + 9)
    assert [next(again) for _ in range(len(flat))] == flat


def test_reference_seconds_left_out_of_setup(tiny_root):
    """The reference's containers: made into an empty cache (its seconds
    are reported apart from setup_s), then read from it."""
    cell = manifest.find_cell(tiny_root, "d24_4k.decode_single")
    codec = harness.codec_of(cell.config)
    seed = 2 ** 31 + 77
    cold, cold_s = harness.make_pool(tiny_root, cell, codec, "containers",
                                     seed, 3, "cpu")
    warm, warm_s = harness.make_pool(tiny_root, cell, codec, "containers",
                                     seed, 3, "cpu")
    assert cold == warm and cold_s > warm_s > 0


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(tiny_root, traced):
    r = harness.execute(tiny_root, "d24_4k.decode_single", 2 ** 31 + 5, 0.2,
                        traced, "cpu")
    want = RESULT_KEYS + (["breakdown"] if traced else []) + ["checks"]
    assert list(r) == want
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    assert ("busy_s" in r["device"]) == traced
    for name, c in r["checks"].items():
        assert set(c) == {"value", "limit"}
    names = set(r["metrics"])
    if traced:
        # Off the card the device readers find no device events; every
        # program span and counter, the benchmark's scan wrapper and the
        # calls' tail read.
        assert names == {f"{n}.latency" for n in (
            "host_busy_ms", "device_wait_ms", "parse_ms", "upload_ms",
            "band_operator_ms", "band_upload_ms", "band_builds",
            "boundary_scan_ms", "host_scan_ms", "call_p95_ms")}
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert r["metrics"]["call_p95_ms.latency"]["value"] > 0
    else:
        assert names == {"decode_p10_ms", "setup_s"}
    json.dumps(r)


def test_per_layer_metrics_move_what_their_cells_report():
    """Each per-layer metric moves an end-to-end metric, and every cell it
    names exists and reports that metric."""
    m = load()
    cells = {w["name"] for w in m["workloads"]}
    e2e = {x["name"]: x for x in m["end_to_end"]}
    for x in m["per_layer"]:
        assert x["moves"] in e2e, x["name"]
        for cell in x.get("workloads", []):
            assert cell in cells, (x["name"], cell)
            assert cell in e2e[x["moves"]].get("workloads", cells), x["name"]


def test_every_per_layer_metric_has_a_reader():
    """Every per-layer name resolves to a reader, every reader is named by
    a per-layer entry, and the retired wrapper of the API's band module
    build is gone with its entries."""
    m = load()
    for x in m["per_layer"]:
        assert callable(manifest.metric_reader(ROOT, x["name"]).read)
        assert not x["name"].startswith("band_build_ms")
    readers = {f[:-3] for f in os.listdir(os.path.join(ROOT, "port_bench",
                                                       "metrics"))
               if f.endswith(".py")}
    assert readers == {x["name"].split(".")[0] for x in m["per_layer"]}
    assert "band_build_ms" not in readers


def _run(args, cwd, env_extra):
    env = dict(os.environ, **env_extra)
    return subprocess.run([sys.executable, "port_bench/run.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_run_fails_without_a_card():
    p = _run(["--workload", "d24_4k.decode_single", "--seed", "1",
              "--seconds", "1", "--trace", "0"], ROOT,
             {"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_run_fails_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    subprocess.run(["cp", "-r", os.path.join(ROOT, "port_bench"),
                    os.path.join(ROOT, "BENCHMARK.json"), str(tmp_path)],
                   check=True)
    p = _run(["--workload", "d24_4k.decode_single", "--seed", "1",
              "--seconds", "1", "--trace", "0"], str(tmp_path),
             {"CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": ""})
    assert p.returncode != 0 and p.stdout == ""
    assert "jpeg_tpu_torch" in p.stderr


def test_unknown_workload_is_refused():
    p = _run(["--workload", "no.such", "--seed", "1", "--seconds", "1"],
             ROOT, {})
    assert p.returncode == 2 and p.stdout == ""


SCAN = """
import sys
sys.path.insert(0, {root!r})
{imports}
print(sorted({{n.split(".")[0] for n in sys.modules}}))
"""


def _loaded(imports):
    p = subprocess.run([sys.executable, "-c",
                        SCAN.format(root=ROOT, imports=imports)],
                       capture_output=True, text=True, timeout=300,
                       cwd="/")
    assert p.returncode == 0, p.stderr
    return set(eval(p.stdout.strip().splitlines()[-1]))


def test_harness_loads_neither_jax_nor_jpeg_tpu():
    loaded = _loaded(
        "import port_bench.run, port_bench.harness, port_bench.control\n"
        "from port_bench import manifest, program\n"
        "program.import_program()\n"
        "for m in manifest.load_manifest({0!r})['per_layer']:\n"
        "    manifest.metric_reader({0!r}, m['name'])\n".format(ROOT))
    assert "jpeg_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "jpeg_tpu"}


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded("import port_bench.reference.codec, port_bench.checks")
    assert not loaded & {"jax", "jaxlib", "flax", "jpeg_tpu",
                         "jpeg_tpu_torch"}


def test_forbidden_names_compared_whole(monkeypatch):
    from port_bench import run
    monkeypatch.setitem(sys.modules, "jpeg_tpu_torch_extra", sys)
    assert run.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jpeg_tpu.api", sys)
    assert run.forbidden_loaded() == ["jpeg_tpu"]


def test_percentile_is_nearest_rank():
    calls = [i / 1000 for i in range(1, 101)]        # 1 .. 100 ms
    assert harness.end_to_end_value("decode_p95_ms", 0, 0, 1, calls) == 95.0
    assert harness.percentile_ms(calls, 5) == 5.0
    assert harness.end_to_end_value("decode_mps", 0, 4_000_000, 2.0,
                                    calls) == 2.0
    with pytest.raises(ValueError):
        harness.end_to_end_value("decode_ms", 0, 0, 1, calls)
