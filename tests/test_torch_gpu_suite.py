"""The on-device suite ``gpu_tests/`` as seen from a machine without a GPU.

``gpu_tests/`` is the port's counterpart of ``tpu_tests/``: it runs on the
card, where there is no JAX, and ``chip_smoke.py`` runs it (phase 4g).
Here it can only be checked from outside:

* no file of it, nor ``chip_smoke.py``, imports ``jax`` or ``jpeg_tpu``
  (the port's own package aside), and the suite imports nothing but
  torch, numpy, pytest, ``jpeg_tpu_torch`` and the standard library;
* every case of ``tpu_tests/test_on_device.py`` has its counterpart;
* ``python -m pytest gpu_tests -q -o addopts= -p no:cacheprovider`` exits
  0 here with every case collected and skipped;
* ``chip_smoke.py``'s phase 4g runs that command and fails unless every
  collected case passed: a skip is a failure there.
"""
import ast
import os
import subprocess
import sys
import xml.etree.ElementTree as ET

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUITE = os.path.join(REPO, "gpu_tests")
SUITE_FILES = sorted(f for f in os.listdir(SUITE) if f.endswith(".py"))
SUITE_CMD = [sys.executable, "-m", "pytest", "gpu_tests", "-q", "-o",
             "addopts=", "-p", "no:cacheprovider"]
# tpu_tests case -> its gpu_tests counterpart.
COUNTERPART = {
    "test_pallas_compiled_matches_xla":
        "test_kernel_branch_matches_f64_tie_contract",
    "test_ragged_combined_decode_on_chip":
        "test_ragged_combined_decode_on_chip",
    "test_roundtrip_quality_and_entropy_modes":
        "test_roundtrip_quality_and_entropy_modes",
    "test_fast_mode_matches_parity_decode":
        "test_fast_mode_matches_parity_decode",
    "test_float64_without_x64_raises_clearly":
        "test_golden_blob_reproduced_in_f64_on_chip",
    "test_exotic_configs_roundtrip": "test_exotic_configs_roundtrip",
    "test_dft_pallas_matches_xla_on_chip":
        "test_dft_kernel_matches_cublas_on_chip",
    "test_foreign_decode_one_dispatch_on_chip":
        "test_foreign_decode_one_dispatch_on_chip",
    "test_device_decode_without_native_codec":
        "test_device_decode_without_native_codec",
    "test_pipelined_many_matches_serial_on_chip":
        "test_pipelined_many_matches_serial_on_chip",
    "test_decompress_plane_on_chip": "test_decompress_plane_on_chip",
    "test_long_run_encode_on_chip": "test_long_run_encode_on_chip",
    "test_sized_encode_on_chip": "test_sized_encode_on_chip",
    "test_merge_kernel_matches_xla_on_chip":
        "test_merge_kernel_matches_plain_on_chip",
    "test_device_scan_on_chip": "test_device_scan_on_chip",
    "test_words_interchange_on_chip": "test_words_interchange_on_chip",
}


def _imports(path):
    """Top-level package names of every absolute import in a file."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def _test_functions(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    return {n.name for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name.startswith("test_")}


@pytest.mark.parametrize("path", [os.path.join("gpu_tests", f)
                                  for f in SUITE_FILES] + ["chip_smoke.py"])
def test_imports_no_jax(path):
    names = set(_imports(os.path.join(REPO, path)))
    assert names and not names & {"jax", "jaxlib", "jpeg_tpu", "tests",
                                  "tpu_tests"}, (path, names)


@pytest.mark.parametrize("name", SUITE_FILES)
def test_suite_imports_torch_numpy_pytest_and_the_port_only(name):
    allowed = {"torch", "numpy", "pytest", "jpeg_tpu_torch"}
    for pkg in _imports(os.path.join(SUITE, name)):
        assert pkg in allowed or pkg in sys.stdlib_module_names, (name, pkg)


def test_every_tpu_tests_case_has_its_counterpart():
    tpu = _test_functions(os.path.join(REPO, "tpu_tests",
                                       "test_on_device.py"))
    gpu = _test_functions(os.path.join(SUITE, "test_on_device.py"))
    assert tpu == set(COUNTERPART)
    assert set(COUNTERPART.values()) <= gpu


def _junit_counts(report):
    root = ET.parse(report).getroot()
    suite = root if root.tag == "testsuite" else root.find("testsuite")
    return {k: int(suite.get(k)) for k in ("tests", "failures", "errors",
                                           "skipped")}


def test_suite_skips_whole_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the suite runs its cases "
                    "(chip_smoke.py phase 4g)")
    report = tmp_path / "gpu_tests.xml"
    res = subprocess.run(SUITE_CMD + [f"--junitxml={report}"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    counts = _junit_counts(report)
    assert counts["tests"] >= 18, counts
    assert counts["skipped"] == counts["tests"], counts
    assert counts["failures"] == counts["errors"] == 0, counts


def test_chip_smoke_phase_fails_on_skips(monkeypatch):
    """Phase 4g runs the suite's command and passes only when every
    collected case passed: here, where every case skips, it fails."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: phase 4g passes there")
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    assert 'log("== phase 4g' in src and "gpu_tests_phase(card)" in src
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke
    calls = []
    run_group = chip_smoke.run_group

    def record(argvs, timeout):
        calls.append(argvs)
        return run_group(argvs, timeout)

    monkeypatch.setattr(chip_smoke, "run_group", record)
    with pytest.raises(AssertionError, match=r"exited 0: 0 of \d+ collected"):
        chip_smoke.gpu_tests_phase("no card")
    (argv,), = calls
    assert argv[:len(SUITE_CMD)] == SUITE_CMD
