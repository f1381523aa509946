"""jpeg_tpu_torch public API vs jpeg_tpu's f32 path, and package isolation.

Contract: containers are byte-equal to ``jpeg_tpu.compress_ycbcr(...,
dtype=np.float32)``'s, except where a level sits at a provable .5 tie
(``encode_reference_and_ties``), where it may differ by 1; decoded planes
equal ``jpeg_tpu.decompress_to_ycbcr(..., dtype=np.float32)``'s except +-1
at ``decode_reference_and_ties`` positions.  Here ``device="cpu"`` runs
every kernel's plain PyTorch version.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jpeg_tpu
import jpeg_tpu.container as jcontainer
import jpeg_tpu.entropy as jentropy
from jpeg_tpu.utils import parity as jparity

import jpeg_tpu_torch
from jpeg_tpu_torch import (BadArrayShapeError, BadRleCodeError,
                            Configuration, QuantizationMethod)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")


def _image(h, w, seed=7):
    """bench.py's synthetic generator (smooth structure, texture, noise)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    out = []
    for c in range(3):
        plane = (128 + 70 * np.sin(x / (17 + 6 * c)) * np.cos(y / (23 - 4 * c))
                 + 30 * np.sin((x + y) / (9 + 2 * c))
                 + 8 * rng.standard_normal((h, w)))
        out.append(np.clip(plane, 0, 255))
    return np.stack(out, axis=-1).astype(np.uint8)


def _cfgs(h, w, qname="qtable", bs=2):
    return (Configuration(width=w, height=h, block_size=bs,
                          quantization=QuantizationMethod(qname)),
            jpeg_tpu.Configuration(width=w, height=h, block_size=bs,
                                   quantization=jpeg_tpu.QuantizationMethod(
                                       qname)))


@pytest.mark.parametrize("h,w,qname", [(64, 96, "qtable"),
                                       (256, 256, "qtable"),
                                       (48, 64, "none")])
def test_compress_matches_jax_f32_except_ties(h, w, qname):
    tcfg, jcfg = _cfgs(h, w, qname)
    img = _image(h, w)
    blob = jpeg_tpu_torch.compress_ycbcr(img, tcfg, device="cpu")
    jblob = jpeg_tpu.compress_ycbcr(img, jcfg, dtype=np.float32)
    if blob == jblob:
        return
    # Only tie-flipped levels may differ: compare the decoded levels.
    _, data = jcontainer.read_data(blob)
    _, jdata = jcontainer.read_data(jblob)
    assert blob[:len(jcontainer.create_header(jcfg))] == \
        jblob[:len(jcontainer.create_header(jcfg))]
    n, L = jcfg.num_blocks, 64
    for b, (s, js) in enumerate(zip((data.y, data.cb, data.cr),
                                    (jdata.y, jdata.cb, jdata.cr))):
        _, ties = jparity.encode_reference_and_ties(jcfg, img[:, :, b])
        jparity.assert_tie_equal(jentropy.decode_levels(s, n, L),
                                 jentropy.decode_levels(js, n, L), ties,
                                 f"band {b}")


@pytest.mark.parametrize("h,w", [(64, 96), (256, 256)])
def test_roundtrip_psnr_and_jax_planes(h, w):
    tcfg, jcfg = _cfgs(h, w)
    img = _image(h, w)
    blob = jpeg_tpu_torch.compress_ycbcr(img, tcfg, device="cpu")
    rec = jpeg_tpu_torch.decompress_to_ycbcr(blob, device="cpu")
    assert rec.shape == img.shape and rec.dtype == np.uint8
    assert jpeg_tpu_torch.psnr(img, rec) > 30.0
    assert jpeg_tpu_torch.psnr(img, rec) == jpeg_tpu.psnr(img, rec)
    want = jpeg_tpu.decompress_to_ycbcr(blob, dtype=np.float32)
    _, data = jcontainer.read_data(blob)
    for b, s in enumerate((data.y, data.cb, data.cr)):
        lv = jentropy.decode_levels(s, jcfg.num_blocks, 64)
        _, ties = jparity.decode_reference_and_ties(jcfg, lv)
        jparity.assert_tie_equal(rec[:, :, b], want[:, :, b], ties,
                                 f"band {b}")


@pytest.mark.parametrize("name", ["default_qtable", "cli_defaults_bs4",
                                  "rounding_none", "discard_d4",
                                  "divide1000_d24"])
def test_golden_decode_matches_jax_f32_except_ties(name):
    with open(os.path.join(GOLDEN, f"{name}.jc"), "rb") as f:
        blob = f.read()
    rec = jpeg_tpu_torch.decompress_to_ycbcr(blob, device="cpu")
    want = jpeg_tpu.decompress_to_ycbcr(blob, dtype=np.float32)
    jcfg, data = jcontainer.read_data(blob)
    L = jcfg.dct_size ** 2
    for b, s in enumerate((data.y, data.cb, data.cr)):
        lv = jentropy.decode_levels(s, jcfg.num_blocks, L)
        _, ties = jparity.decode_reference_and_ties(jcfg, lv)
        jparity.assert_tie_equal(rec[:, :, b], want[:, :, b], ties,
                                 f"{name} band {b}")


def test_dft_golden_decode_is_not_ported_yet():
    """The DFT golden (bs 3, padded) decodes to the manifest's plane hash in
    the parity mode, and within the tie contract of ``jpeg_tpu``'s f32
    decode in f32."""
    import hashlib
    import json
    with open(os.path.join(GOLDEN, "dft_none.jc"), "rb") as f:
        blob = f.read()
    with open(os.path.join(GOLDEN, "manifest.json")) as f:
        entry = json.load(f)["dft_none"]
    rec64 = jpeg_tpu_torch.decompress_to_ycbcr(blob, device="cpu",
                                               dtype=torch.float64)
    assert list(rec64.shape) == entry["decoded_shape"]
    assert hashlib.sha256(rec64.tobytes()).hexdigest() == \
        entry["decoded_sha256"]
    rec = jpeg_tpu_torch.decompress_to_ycbcr(blob, device="cpu")
    want = jpeg_tpu.decompress_to_ycbcr(blob, dtype=np.float32)
    jcfg, data = jcontainer.read_data(blob)
    for b, s in enumerate((data.y, data.cb, data.cr)):
        lv = jentropy.decode_levels(s, jcfg.num_blocks, 64)
        _, ties = jparity.decode_reference_and_ties(jcfg, lv)
        jparity.assert_tie_equal(rec[:, :, b], want[:, :, b], ties,
                                 f"dft band {b}")


def test_amplitude_check_runs_before_encode():
    """|level| > 16383 is unrepresentable: rejected from phase 1's max
    before any entropy coding (d = 16, 'none': the DC of a white block is
    255 * 256)."""
    cfg = Configuration(width=32, height=32, block_size=1, dct_size=16)
    img = np.full((32, 32, 3), 255, np.uint8)
    with pytest.raises(BadRleCodeError, match="16383"):
        jpeg_tpu_torch.compress_ycbcr(img, cfg, device="cpu")


def test_input_shape_checks():
    tcfg, _ = _cfgs(32, 48)
    with pytest.raises(ValueError, match="YCbCr"):
        jpeg_tpu_torch.compress_ycbcr(np.zeros((32, 48), np.uint8), tcfg,
                                      device="cpu")
    with pytest.raises(BadArrayShapeError):
        jpeg_tpu_torch.compress_ycbcr(np.zeros((48, 32, 3), np.uint8), tcfg,
                                      device="cpu")


_FP32_SWITCHES = {        # torch's per-backend float32 precision settings
    "generic": torch.backends,
    "cuda.matmul": torch.backends.cuda.matmul,
    "cudnn.conv": torch.backends.cudnn.conv,
    "cudnn.rnn": torch.backends.cudnn.rnn,
    "mkldnn.matmul": torch.backends.mkldnn.matmul,
    "mkldnn.conv": torch.backends.mkldnn.conv}


def _precision_state():
    """Every TF32 / reduced-precision switch torch has, per-backend and
    legacy; a legacy reader raises once the two APIs were mixed."""
    state = {k: m.fp32_precision for k, m in _FP32_SWITCHES.items()}
    for name, read in (
            ("allow_tf32", lambda: torch.backends.cuda.matmul.allow_tf32),
            ("cudnn.allow_tf32", lambda: torch.backends.cudnn.allow_tf32),
            ("matmul_precision", torch.get_float32_matmul_precision)):
        try:
            state[name] = read()
        except RuntimeError:
            state[name] = "raises"
    return state


def _set_tf32_legacy():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True


def _set_tf32_per_backend():
    torch.backends.cuda.matmul.fp32_precision = "tf32"


@pytest.mark.parametrize("caller", [
    "default", "allow_tf32", "precision_high", "precision_medium",
    "fp32_precision_tf32"])
def test_codec_leaves_the_callers_precision_settings(caller):
    """The codec's f32 products run in full f32 whatever the caller chose:
    its container and planes are the same bytes as under torch's defaults
    (although "medium" makes the CPU's own products bf16).  And every
    precision setting of the caller is as it was once compress_ycbcr and
    decompress_to_ycbcr return."""
    from jpeg_tpu_torch.utils.device import full_f32_matmul
    tcfg, _ = _cfgs(32, 48)
    img = _image(32, 48)
    want_blob = jpeg_tpu_torch.compress_ycbcr(img, tcfg, device="cpu")
    want_img = jpeg_tpu_torch.decompress_to_ycbcr(want_blob, device="cpu")
    before = _precision_state()
    setup = {"default": lambda: None,
             "allow_tf32": _set_tf32_legacy,
             "precision_high":
                 lambda: torch.set_float32_matmul_precision("high"),
             "precision_medium":
                 lambda: torch.set_float32_matmul_precision("medium"),
             "fp32_precision_tf32": _set_tf32_per_backend}[caller]
    try:
        setup()
        callers = _precision_state()
        with full_f32_matmul():
            inside = _precision_state()
        assert inside["cuda.matmul"] == inside["mkldnn.matmul"] == "ieee"
        assert _precision_state() == callers
        blob = jpeg_tpu_torch.compress_ycbcr(img, tcfg, device="cpu")
        assert _precision_state() == callers
        rec = jpeg_tpu_torch.decompress_to_ycbcr(blob, device="cpu")
        assert _precision_state() == callers
        assert blob == want_blob
        np.testing.assert_array_equal(rec, want_img)
    finally:
        # back to the state before: the legacy switches first (they also
        # write the per-backend settings), then the per-backend settings
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("highest")
        for k, m in _FP32_SWITCHES.items():
            m.fp32_precision = before[k]
    assert _precision_state() == before


def test_cuda_without_gpu_raises_instead_of_falling_back(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    tcfg, _ = _cfgs(32, 48)
    img = _image(32, 48)
    with pytest.raises(RuntimeError, match="cuda"):
        jpeg_tpu_torch.compress_ycbcr(img, tcfg)
    blob = jpeg_tpu_torch.compress_ycbcr(img, tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        jpeg_tpu_torch.decompress_to_ycbcr(blob)
    with pytest.raises(ValueError, match="unsupported device"):
        jpeg_tpu_torch.decompress_to_ycbcr(blob, device="meta")
    from jpeg_tpu_torch import parallel
    from jpeg_tpu_torch.cli import batch
    with pytest.raises(RuntimeError, match="cuda"):
        parallel.make_mesh()
    from PIL import Image
    (tmp_path / "in").mkdir()
    Image.fromarray(img, "RGB").save(tmp_path / "in" / "a.png")
    (tmp_path / "jc").mkdir()
    (tmp_path / "jc" / "a.jc").write_bytes(blob)
    for indir, flags in (("in", []), ("in", ["--mesh"]),
                         ("jc", ["--decompress"])):
        # the CLI's default --device is cuda
        with pytest.raises(RuntimeError, match="cuda"):
            batch.main([str(tmp_path / indir), str(tmp_path / "out"),
                        *flags])


def test_import_leaves_jax_and_jpeg_tpu_out():
    """In a fresh interpreter, importing the port (every module of it)
    loads neither jax nor jpeg_tpu."""
    code = (
        "import sys, pkgutil, importlib, jpeg_tpu_torch\n"
        "for m in pkgutil.walk_packages(jpeg_tpu_torch.__path__, "
        "'jpeg_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'jpeg_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'jpeg_tpu_torch.entropy.device_scan' in sys.modules\n"
        "assert 'jpeg_tpu_torch.parallel.multihost' in sys.modules\n"
        "assert 'jpeg_tpu_torch.cli.batch' in sys.modules\n"
        "assert callable(jpeg_tpu_torch.decompress_many)\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_port_sources_import_no_jax_and_compile_nothing():
    """Static check of every module: no jax / jpeg_tpu import, no
    torch.compile, no environment variable read."""
    pkg = os.path.join(REPO, "jpeg_tpu_torch")
    seen = 0
    for root, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            seen += 1
            src = open(os.path.join(root, f)).read()
            assert "torch.compile" not in src, f
            assert "environ" not in src and "getenv" not in src, f
            for node in ast.walk(ast.parse(src)):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                for name in names:
                    assert name.split(".")[0] not in ("jax", "jaxlib",
                                                      "jpeg_tpu"), (f, name)
    assert seen >= 33          # parallel/, cli/, __main__.py ... included


def _string_constants(src: str):
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.value


def test_port_opens_and_compiles_no_file_of_jpeg_tpu():
    """The port keeps its own copy of what it needs (the host C++ codec
    included): no module holds a path under jpeg_tpu/, whole or as a
    ``"jpeg_tpu"`` component to join (a docstring may name a counterpart
    in backquotes), and the codec compiles the port's own entropy.cpp, a
    byte-for-byte copy of the JAX package's."""
    import re
    from jpeg_tpu_torch.entropy import native_codec
    pkg = os.path.join(REPO, "jpeg_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(root, f)).read()
                assert "jpeg_tpu" not in set(_string_constants(src)), f
                assert not re.search(r"(?<![`\w])jpeg_tpu/", src), f
    src = os.path.realpath(native_codec._SRC)
    assert src == os.path.join(os.path.realpath(pkg), "entropy", "native",
                               "entropy.cpp")
    with open(src, "rb") as a, open(os.path.join(
            REPO, "jpeg_tpu", "entropy", "native", "entropy.cpp"), "rb") as b:
        assert a.read() == b.read()
    if native_codec.available():
        so = native_codec._so_path()
        assert so.startswith(os.path.join(REPO, "build", "native"))
