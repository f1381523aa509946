"""jpeg_tpu_torch's CLI and profiling module vs jpeg_tpu's.

Mirrors the single-process cases of ``tests/test_batch_cli.py`` (roundtrip
and metrics, resume, corrupt input, ``--mesh`` equal to serial,
``--decompress`` with a corrupt blob bisected, ``__main__`` dispatch, the
profiler trace smoke), every command with ``--device cpu`` (the kernels'
plain versions).  Also: the compress / decompress CLIs' output files are
byte-equal to ``jpeg_tpu.cli``'s in f64, the parsers take every flag of
their JAX counterparts plus ``--device``, ``Metrics.to_dict()`` equals
``jpeg_tpu.utils.profiling.Metrics``' after the same ``add_image`` calls,
and ``StageTimer`` fences CPU tensors.
"""
import json
import os

import numpy as np
import pytest
import torch

from jpeg_tpu.cli import batch as jbatch
from jpeg_tpu.cli import compress as jcompress
from jpeg_tpu.utils import profiling as jprofiling

import jpeg_tpu_torch
from jpeg_tpu_torch import parallel
from jpeg_tpu_torch.cli import batch
from jpeg_tpu_torch.cli import compress as C
from jpeg_tpu_torch.cli import decompress as D
from jpeg_tpu_torch.utils.profiling import Metrics, StageTimer, trace

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

torch.set_num_threads(2)

pytestmark = pytest.mark.filterwarnings(
    "ignore:dimension of size:UserWarning",
    "ignore:The given NumPy array is not writable:UserWarning")


def _write_png(path, h, w, phase=0.0):
    # Smooth gradient + low-frequency waves: realistic compressible content.
    y, x = np.mgrid[0:h, 0:w]
    arr = np.stack([128 + 60 * np.sin(x / 7.0 + phase),
                    128 + 60 * np.cos(y / 9.0),
                    (255.0 * (x + y)) / (h + w)], axis=-1)
    Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8), "RGB").save(path)


def _run(indir, outdir, *flags):
    args = batch.build_parser().parse_args(
        [str(indir), str(outdir), "--device", "cpu", *flags])
    mesh = None
    if args.mesh:
        mesh = parallel.make_mesh(devices=[torch.device("cpu")] * 8)
    return batch.run(str(indir), str(outdir), args, mesh=mesh)


def test_batch_roundtrip_and_metrics(tmp_path):
    indir, outdir = tmp_path / "in", tmp_path / "out"
    indir.mkdir()
    for i, (h, w) in enumerate([(24, 32), (24, 32), (16, 16)]):
        _write_png(indir / f"img{i}.png", h, w)
    m = _run(indir, outdir, "--verify", "--block_size", "2")
    assert m.images == 3 and m.failures == 0
    assert m.compressed_bytes > 0 and m.seconds > 0
    assert m.psnr_count == 3 and m.psnr_sum / 3 > 25
    d = json.loads(m.json_line())
    assert d["images"] == 3 and d["compression_ratio"] > 0
    assert sorted(os.listdir(outdir)) == ["img0.jc", "img1.jc", "img2.jc"]
    for i in range(3):
        im = np.asarray(Image.open(indir / f"img{i}.png").convert("YCbCr"))
        cfg = jpeg_tpu_torch.Configuration(
            width=im.shape[1], height=im.shape[0], block_size=2,
            quantization=jpeg_tpu_torch.QuantizationMethod("qtable"))
        assert (outdir / f"img{i}.jc").read_bytes() == \
            jpeg_tpu_torch.compress_ycbcr(im, cfg, device="cpu")


def test_batch_resume_skips_existing(tmp_path):
    indir, outdir = tmp_path / "in", tmp_path / "out"
    indir.mkdir()
    _write_png(indir / "a.png", 16, 16)
    _write_png(indir / "b.png", 16, 16)
    m1 = _run(indir, outdir, "--block_size", "2")
    assert m1.images == 2
    m2 = _run(indir, outdir, "--block_size", "2")
    assert m2.images == 0 and m2.failures == 0
    m3 = _run(indir, outdir, "--block_size", "2", "--force")
    assert m3.images == 2


def test_batch_skips_corrupt_input(tmp_path):
    indir, outdir = tmp_path / "in", tmp_path / "out"
    indir.mkdir()
    _write_png(indir / "good.png", 16, 16)
    (indir / "bad.png").write_bytes(b"not a png at all")
    m = _run(indir, outdir, "--block_size", "2")
    assert m.images == 1 and m.failures == 1
    assert os.listdir(outdir) == ["good.jc"]


@pytest.mark.parametrize("hw", [(24, 32), (128, 40)])
def test_batch_mesh_dispatch_matches_serial(tmp_path, hw):
    """(128, 40): 8 block rows, one a device of the 8-entry mesh."""
    indir, out1, out2 = tmp_path / "in", tmp_path / "o1", tmp_path / "o2"
    indir.mkdir()
    for i in range(4):
        _write_png(indir / f"img{i}.png", *hw, phase=i)
    _run(indir, out1, "--block_size", "2")
    _run(indir, out2, "--block_size", "2", "--mesh")
    assert sorted(os.listdir(out1)) == sorted(os.listdir(out2))
    for f in sorted(os.listdir(out1)):
        assert (out1 / f).read_bytes() == (out2 / f).read_bytes()


def test_stage_timer_and_metrics_report():
    t = StageTimer()
    with t.stage("x"):
        pass
    with t.stage("x") as s:
        out = s.fence(torch.arange(4).sum())
        s.fence({"a": [out, (torch.zeros(2),)], "b": 3})
    assert t.counts["x"] == 2 and t.totals["x"] >= 0
    assert "x" in str(t) and list(t.report()) == ["x"]

    m = Metrics()
    m.add_image(100, 100, 5000, 0.5, psnr=40.0)
    d = m.to_dict()
    assert d["compression_ratio"] == 6.0
    assert d["mean_psnr_db"] == 40.0
    assert abs(m.megapixels_per_s - 0.02) < 1e-9


def test_stage_timer_fences_only_cuda_tensors(monkeypatch):
    """A CPU tensor needs no synchronize; nested values are walked."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: calls.append(dev))
    t = StageTimer()
    with t.stage("cpu") as s:
        s.fence([torch.ones(3), {"k": (torch.zeros(1),)}])
    assert calls == []
    from jpeg_tpu_torch.utils import profiling
    assert profiling._cuda_devices([torch.ones(1), {"k": (1, "x")}],
                                   set()) == set()


@pytest.mark.parametrize("calls", [
    [(100, 100, 5000, 0.5, 40.0)],
    [(24, 32, 300, 0.012, None), (1080, 1920, 123456, 0.25, 38.123456),
     (7, 5, 1, 1e-4, 20.0)],
    [],
])
def test_metrics_match_jax(calls):
    t, j = Metrics(), jprofiling.Metrics()
    for c in calls:
        t.add_image(*c)
        j.add_image(*c)
    t.failures = j.failures = len(calls) % 2
    t.extra["note"] = j.extra["note"] = 1.5
    assert t.to_dict() == j.to_dict()
    assert t.json_line() == j.json_line()
    assert t.megapixels_per_s == j.megapixels_per_s
    assert t.compression_ratio == j.compression_ratio


def test_compress_cli_mesh_flag_identical_bytes(tmp_path):
    _write_png(tmp_path / "img.png", 32, 48)
    C.main([str(tmp_path / "img.png"), str(tmp_path / "a.jc"),
            "--block_size", "2", "--device", "cpu"])
    C.main([str(tmp_path / "img.png"), str(tmp_path / "b.jc"),
            "--block_size", "2", "--mesh", "--device", "cpu"])
    assert (tmp_path / "a.jc").read_bytes() == (tmp_path / "b.jc").read_bytes()


@pytest.mark.parametrize("flags", [[], ["--block_size", "2"],
                                   ["--quantization", "divide",
                                    "--qdivisor", "7"],
                                   ["--quantization", "discard", "--qkeep",
                                    "3", "--block_size", "3"],
                                   ["--transform", "DFT", "--quantization",
                                    "none"]])
def test_cli_files_byte_equal_jax_f64(tmp_path, flags):
    """compress and decompress output files equal jpeg_tpu.cli's on the
    same PNG in the f64 mode."""
    from jpeg_tpu.cli import decompress as jdecompress
    _write_png(tmp_path / "img.png", 27, 38)
    src = str(tmp_path / "img.png")
    C.main([src, str(tmp_path / "t.jc"), "--dtype", "float64",
            "--device", "cpu", *flags])
    jcompress.main([src, str(tmp_path / "j.jc"), "--dtype", "float64",
                    *flags])
    assert (tmp_path / "t.jc").read_bytes() == \
        (tmp_path / "j.jc").read_bytes()
    D.main([str(tmp_path / "t.jc"), str(tmp_path / "t.png"),
            "--dtype", "float64", "--device", "cpu"])
    jdecompress.main([str(tmp_path / "j.jc"), str(tmp_path / "j.png"),
                      "--dtype", "float64"])
    assert (tmp_path / "t.png").read_bytes() == \
        (tmp_path / "j.png").read_bytes()


def _flags(parser):
    return {a.dest: (a.default, a.option_strings) for a in parser._actions}


def test_parsers_take_every_jax_flag_plus_device():
    tb, jb = _flags(batch.build_parser()), _flags(jbatch.build_parser())
    tc, jc = _flags(C.build_parser()), _flags(jcompress.build_parser())
    for t, j in ((tb, jb), (tc, jc)):
        assert t.pop("device") == ("cuda", ["--device"])
        assert t == j
    args = batch.build_parser().parse_args(["a", "b"])
    assert args.device == "cuda"


def test_cli_default_device_raises_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    _write_png(tmp_path / "img.png", 16, 16)
    with pytest.raises(RuntimeError, match="cuda"):
        C.main([str(tmp_path / "img.png"), str(tmp_path / "o.jc")])
    with pytest.raises(RuntimeError, match="cuda"):
        batch.main([str(tmp_path), str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="cuda"):
        batch.main([str(tmp_path), str(tmp_path / "out2"), "--mesh"])


def test_profiler_trace_smoke(tmp_path):
    with trace(str(tmp_path / "tr")):
        torch.arange(8).sum()
    files = list((tmp_path / "tr").rglob("*.json"))
    assert files, "no trace output written"
    assert "traceEvents" in json.loads(files[0].read_text())
    with trace(None):   # disabled path is a no-op
        pass
    assert not (tmp_path / "None").exists()


def test_module_main_dispatch(tmp_path, capsys):
    from jpeg_tpu_torch.__main__ import main
    _write_png(tmp_path / "img.png", 16, 16)
    assert main(["compress", str(tmp_path / "img.png"),
                 str(tmp_path / "o.jc"), "--block_size", "2",
                 "--device", "cpu"]) == 0
    assert main(["decompress", str(tmp_path / "o.jc"),
                 str(tmp_path / "r.png"), "--device", "cpu"]) == 0
    assert (tmp_path / "r.png").exists()
    assert main(["nonsense"]) == 2
    assert main([]) == 2
    assert main(["--help"]) == 0
    assert "jpeg_tpu_torch" in capsys.readouterr().out
    indir = tmp_path / "in"
    indir.mkdir()
    _write_png(indir / "a.png", 16, 16)
    assert main(["batch", str(indir), str(tmp_path / "b"), "--device",
                 "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.strip())["images"] == 1


def test_batch_decompress_roundtrip(tmp_path):
    indir, cdir, rdir = tmp_path / "in", tmp_path / "jc", tmp_path / "rec"
    indir.mkdir()
    for i in range(3):
        _write_png(indir / f"img{i}.png", 24, 32, phase=i)
    _run(indir, cdir, "--block_size", "2")
    args = batch.build_parser().parse_args(
        [str(cdir), str(rdir), "--decompress", "--device", "cpu"])
    m = batch.run_decompress(str(cdir), str(rdir), args)
    assert m.images == 3 and m.failures == 0
    assert sorted(os.listdir(rdir)) == ["img0.png", "img1.png", "img2.png"]
    for i in range(3):
        rec = np.asarray(Image.open(rdir / f"img{i}.png"))
        want = jpeg_tpu_torch.decompress_to_ycbcr(
            (cdir / f"img{i}.jc").read_bytes(), device="cpu")
        np.testing.assert_array_equal(
            rec, np.asarray(Image.fromarray(want, "YCbCr").convert("RGB")))
    m2 = batch.run_decompress(str(cdir), str(rdir), args)
    assert m2.images == 0
    # corrupt container: skipped and reported, good ones still decoded
    (cdir / "bad.jc").write_bytes(b"\x01\x02corrupt")
    for f in rdir.iterdir():
        f.unlink()
    m3 = batch.run_decompress(str(cdir), str(rdir), args)
    assert m3.failures == 1 and m3.images == 3
