"""jpeg_tpu_torch's f64 parity mode (``dtype=torch.float64``) vs the
golden blobs and jpeg_tpu's f64 path.

Tolerance: none.  The parity mode reproduces the reference bit for bit, so
every comparison here is exact: the six ``tests/golden/*.jc`` blobs byte
for byte, their recorded plane hashes, and ``jpeg_tpu``'s f64 levels and
planes (``make_encode`` / ``make_decode(key, "float64")``, the JAX package
in x64 mode, as ``tests/conftest.py`` sets it).
"""
import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jpeg_tpu
from jpeg_tpu.config import Configuration as JConfiguration
from jpeg_tpu.config import QuantizationMethod as JQuantizationMethod
from jpeg_tpu.ops import band as jband
from jpeg_tpu.ops import transform as JT

import jpeg_tpu_torch
from jpeg_tpu_torch.config import Configuration, QuantizationMethod
from jpeg_tpu_torch.ops import transform as T
from jpeg_tpu_torch.ops.band import BandDecoder, BandEncoder

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
with open(os.path.join(GOLDEN, "manifest.json")) as f:
    MANIFEST = json.load(f)
F64 = torch.float64


def _synth(h, w):
    """``tests/test_golden.py``'s generator of the golden images."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    rng = np.random.default_rng(42)
    img = np.stack([128 + 70 * np.sin(x / 13) * np.cos(y / 11),
                    128 + 50 * np.cos(x / 7),
                    np.clip(8 * rng.standard_normal((h, w)) + 128, 0, 255)],
                   -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def _kwargs(entry):
    kw = dict(entry["config"])
    q = kw.pop("quantization", None)
    return kw, (q["name"], q["params"]) if q else ("none", {})


def _cfgs(kw, q):
    qname, qparams = q
    return (Configuration(**kw,
                          quantization=QuantizationMethod(qname, **qparams)),
            JConfiguration(**kw,
                           quantization=JQuantizationMethod(qname,
                                                            **qparams)))


def _blob(name):
    with open(os.path.join(GOLDEN, f"{name}.jc"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_parity_encode_reproduces_golden_blob(name):
    kw, q = _kwargs(MANIFEST[name])
    cfg, _ = _cfgs(kw, q)
    blob = jpeg_tpu_torch.compress_ycbcr(_synth(cfg.height, cfg.width), cfg,
                                         device="cpu", dtype=F64)
    assert hashlib.sha256(blob).hexdigest() == MANIFEST[name]["blob_sha256"]
    assert blob == _blob(name)


@pytest.mark.parametrize("scan", ["host", "device"])
@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_parity_decode_reproduces_golden_planes(name, scan):
    out = jpeg_tpu_torch.decompress_to_ycbcr(_blob(name), device="cpu",
                                             scan=scan, dtype=F64)
    assert list(out.shape) == MANIFEST[name]["decoded_shape"]
    assert hashlib.sha256(out.tobytes()).hexdigest() == \
        MANIFEST[name]["decoded_sha256"]


EXTRA = {   # beside the goldens: bs 5 padded, DFT divisible, d 24 bs 1
    "bs5_qtable": ({"height": 46, "width": 61, "block_size": 5},
                   ("qtable", {})),
    "dft_divisible_divide3": ({"height": 32, "width": 48, "block_size": 2,
                               "transform": "DFT"},
                              ("divide", {"divisor": 3})),
    "d24_bs1_divide2.5": ({"height": 30, "width": 50, "block_size": 1,
                           "dct_size": 24}, ("divide", {"divisor": 2.5})),
}
CASES = {**{n: _kwargs(e) for n, e in MANIFEST.items()}, **EXTRA}


@pytest.mark.parametrize("name", sorted(CASES))
def test_parity_levels_and_planes_bitwise_equal_jax_f64(name):
    kw, q = CASES[name]
    tcfg, jcfg = _cfgs(kw, q)
    key = jband.config_key(jcfg)
    img = _synth(tcfg.height, tcfg.width).transpose(2, 0, 1).copy()
    enc = BandEncoder(tcfg, F64)
    assert enc.branch == "parity" and enc.mul.dtype == F64
    got = enc(torch.from_numpy(img)).numpy()
    dec = BandDecoder(tcfg, F64)
    assert dec.branch == "parity"
    planes = dec(torch.from_numpy(got)).numpy()
    jenc = jband.make_encode(key, "float64")
    jdec = jband.make_decode(key, "float64")
    for b in range(3):
        want = np.asarray(jenc(jnp.asarray(img[b])))
        np.testing.assert_array_equal(got[b], want, err_msg=f"band {b}")
        np.testing.assert_array_equal(
            planes[b], np.asarray(jdec(jnp.asarray(want))),
            err_msg=f"plane {b}")


@pytest.mark.parametrize("d", [4, 8, 24])
def test_exact_host_transforms_bitwise_equal_jax(d):
    rng = np.random.default_rng(d)
    blocks = rng.integers(0, 256, (5, d, d)).astype(np.float64) / 3
    coeffs = np.round(rng.standard_normal((5, d * d)) * 300)
    for a, b in zip(T._ref_matrices(d), JT._ref_matrices(d)):
        np.testing.assert_array_equal(a, b)
    for name, x in (("_host_dct2", blocks), ("_host_idct2", blocks),
                    ("_host_fft2_real", blocks), ("_host_ifft2_real", blocks)):
        np.testing.assert_array_equal(getattr(T, name)(x, d),
                                      getattr(JT, name)(x, d), err_msg=name)
    for name, x in (("exact_dct2_zigzag", blocks),
                    ("exact_dft2_real_zigzag", blocks),
                    ("exact_izigzag_idct2", coeffs),
                    ("exact_izigzag_idft2_real", coeffs)):
        np.testing.assert_array_equal(
            getattr(T, name)(x, d),
            np.asarray(getattr(JT, name)(jnp.asarray(x), d)), err_msg=name)


def test_parity_band_api_matches_jax():
    kw, q = _kwargs(MANIFEST["cli_defaults_bs4"])
    tcfg, jcfg = _cfgs(kw, q)
    band = _synth(tcfg.height, tcfg.width)[:, :, 0]
    data = jpeg_tpu_torch.compress_band(band, tcfg, device="cpu", dtype=F64)
    assert data == jpeg_tpu.compress_band(band, jcfg, dtype=np.float64)
    got = jpeg_tpu_torch.decompress_band(data, tcfg, device="cpu", dtype=F64)
    np.testing.assert_array_equal(
        got, jpeg_tpu.decompress_band(data, jcfg, dtype=np.float64))


def test_parity_batch_apis_and_jpeg():
    names = ["dft_none", "cli_defaults_bs4"]
    cfgs = [_cfgs(*_kwargs(MANIFEST[n]))[0] for n in names]
    imgs = [_synth(c.height, c.width) for c in cfgs]
    blobs = [_blob(n) for n in names]
    assert jpeg_tpu_torch.compress_many([imgs[0], imgs[0]], cfgs[0],
                                        device="cpu", dtype=F64) \
        == [blobs[0], blobs[0]]
    assert jpeg_tpu_torch.Jpeg(cfgs[1], device="cpu",
                               dtype=F64).compress(imgs[1]) == blobs[1]
    recs = jpeg_tpu_torch.decompress_many(blobs, device="cpu", dtype=F64)
    for n, rec in zip(names, recs):
        assert hashlib.sha256(rec.tobytes()).hexdigest() == \
            MANIFEST[n]["decoded_sha256"]
    planes = jpeg_tpu_torch.decompress_to_device(blobs[0], device="cpu",
                                                 dtype=F64)
    np.testing.assert_array_equal(planes.numpy().transpose(1, 2, 0), recs[0])
    arr = jpeg_tpu_torch.Jpeg.decompress(blobs[1], device="cpu", dtype=F64)
    np.testing.assert_array_equal(np.asarray(arr), recs[1])


def test_dtype_argument_is_checked():
    cfg, _ = _cfgs(*_kwargs(MANIFEST["rounding_none"]))
    img = _synth(cfg.height, cfg.width)
    for bad in (torch.float16, np.float16, "int32", "half"):
        with pytest.raises(ValueError, match="dtype"):
            jpeg_tpu_torch.compress_ycbcr(img, cfg, device="cpu", dtype=bad)
        with pytest.raises(ValueError, match="dtype"):
            BandDecoder(cfg, bad)
    # The reference's numpy spellings of the parity mode are accepted.
    want = jpeg_tpu_torch.compress_ycbcr(img, cfg, device="cpu", dtype=F64)
    for good in (np.float64, np.dtype("float64"), "float64"):
        assert BandDecoder(cfg, good).dtype == F64
        assert jpeg_tpu_torch.compress_ycbcr(img, cfg, good,
                                             device="cpu") == want
    assert BandEncoder(cfg, torch.float32).branch == \
        BandEncoder(cfg).branch == "sep_pad"
