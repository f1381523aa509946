"""Faults of jpeg_tpu_torch found against the reference, each held here.

1. A container whose header declares more blocks than its streams can hold
   raises the host scanner's ``BadStreamError`` with ``scan="device"``
   before the decode sizes anything from the header's geometry.
2. The top-level package exports every public name of ``jpeg_tpu``.
3. Calls in the reference's positional form give the reference's results
   (``device`` is keyword-only after the reference's parameters), and the
   reference's numpy spellings of the parity dtype are accepted.

Tolerance: none.  The positional calls run the f64 parity mode, which
reproduces ``jpeg_tpu``'s f64 path (x64, as ``tests/conftest.py`` sets it)
bit for bit; the f32 batch decode is compared with the port's own keyword
form of the same call.
"""
import numpy as np
import pytest
import torch

import jpeg_tpu
from jpeg_tpu.config import Configuration as JConfiguration
from jpeg_tpu.config import QuantizationMethod as JQuantizationMethod

import jpeg_tpu_torch
from jpeg_tpu_torch import api, container
from jpeg_tpu_torch.config import BadStreamError, Configuration
from jpeg_tpu_torch.config import QuantizationMethod
from jpeg_tpu_torch.entropy import device_scan as DS

torch.set_num_threads(2)
F64 = np.float64


def _cfgs(w=40, h=24, bs=2, d=8):
    kw = dict(width=w, height=h, block_size=bs, dct_size=d)
    return (Configuration(**kw, quantization=QuantizationMethod("qtable")),
            JConfiguration(**kw,
                           quantization=JQuantizationMethod("qtable")))


def _image(h=24, w=40, seed=5):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = 128 + 60 * np.sin(x / 7.0)[..., None] * np.cos(y / 5.0)[..., None]
    return np.clip(base + rng.normal(0, 9, (h, w, 3)), 0, 255).astype(
        np.uint8)


# ---------------------------------------------------------------------------
# 1. A forged header
# ---------------------------------------------------------------------------

def _forged_blob():
    """A 40x24 image's container with its header rewritten to 30000x30000
    (bs 1, d 8): 14,062,500 blocks a band, 1.4 KB of streams."""
    cfg, _ = _cfgs()
    blob = jpeg_tpu_torch.compress_ycbcr(_image(), cfg, device="cpu")
    _, data = container.read_data(blob)
    big = Configuration(width=30000, height=30000, block_size=1, dct_size=8,
                        quantization=QuantizationMethod("qtable"))
    return container.generate_data(big, data), big


@pytest.fixture
def nothing_sized_from_the_header(monkeypatch):
    """Fail any step of the decode's device-scan branch that sizes from
    num_blocks, and the host branch's scan, where ``api`` calls them."""
    def refuse(name):
        def fn(*a, **k):
            raise AssertionError(f"{name} called for a forged header")
        return fn
    monkeypatch.setattr(api, "BandDecoder", refuse("BandDecoder"))
    monkeypatch.setattr(api.DC, "decode_stream", refuse("decode_stream"))
    monkeypatch.setattr(api.DC, "upload_stream", refuse("upload_stream"))
    monkeypatch.setattr(api.DS, "scan_bands_starts",
                        refuse("scan_bands_starts"))
    monkeypatch.setattr(DS, "upload_stream", refuse("upload_stream"))
    monkeypatch.setattr(api.entropy, "scan_offsets", refuse("scan_offsets"))


@pytest.mark.parametrize("entry", ["decompress_to_ycbcr",
                                   "decompress_to_device", "decompress_many"])
def test_forged_header_raises_before_the_device_scan_sizes_anything(
        entry, nothing_sized_from_the_header):
    blob, big = _forged_blob()
    assert len(blob) < 2000 and big.num_blocks == 14_062_500
    fn = getattr(jpeg_tpu_torch, entry)
    arg = [blob] if entry == "decompress_many" else blob
    with pytest.raises(BadStreamError, match="truncated"):
        fn(arg, device="cpu", scan="device")


def test_forged_header_same_error_as_the_host_scan_and_the_reference():
    blob, _ = _forged_blob()
    with pytest.raises(BadStreamError, match="truncated"):
        jpeg_tpu_torch.decompress_to_ycbcr(blob, device="cpu", scan="host")
    with pytest.raises(jpeg_tpu.BadStreamError, match="truncated"):
        jpeg_tpu.decompress_to_ycbcr(blob)


def test_short_band_fails_the_device_scan_without_an_upload(
        nothing_sized_from_the_header):
    data = b"\x00" * 10                  # ten EOB-only blocks
    starts, ok = DS.scan_offsets_device(data, 11, 64, device="cpu")
    assert not ok and starts.size == 0
    with pytest.raises(BadStreamError, match="truncated"):
        DS.scan_offsets_hybrid(data, 11, 64, device="cpu")


# ---------------------------------------------------------------------------
# 2. Public names
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jpeg_tpu.__all__))
def test_every_public_name_of_the_reference_is_exported(name):
    assert name in jpeg_tpu_torch.__all__
    assert getattr(jpeg_tpu_torch, name).__module__.startswith(
        "jpeg_tpu_torch.")


def test_version_and_star_import_match_the_reference():
    assert jpeg_tpu_torch.__version__ == jpeg_tpu.__version__
    ns = {}
    exec("from jpeg_tpu_torch import *", ns)
    assert set(jpeg_tpu.__all__) <= set(ns)
    cfg, _ = _cfgs()
    assert jpeg_tpu_torch.get_header(jpeg_tpu_torch.create_header(cfg)) == cfg
    assert jpeg_tpu_torch.padded_size(41, 8) == jpeg_tpu.padded_size(41, 8)


# ---------------------------------------------------------------------------
# 3. The reference's positional form
# ---------------------------------------------------------------------------

def _positional_case(name):
    """(the port's call, the reference's call), both positional in the
    reference's parameter order, the port with ``device="cpu"`` added."""
    cfg, jcfg = _cfgs()
    img, img2 = _image(), _image(seed=9)
    band = img[:, :, 0].astype(np.int32)
    blob = jpeg_tpu.compress_ycbcr(img, jcfg, F64)
    blob2 = jpeg_tpu.compress_ycbcr(img2, jcfg, F64)
    data = jpeg_tpu.compress_band(band, jcfg, F64)
    cpu = dict(device="cpu")
    return {
        "compress_band": (
            lambda: jpeg_tpu_torch.compress_band(band, cfg, F64, **cpu),
            lambda: jpeg_tpu.compress_band(band, jcfg, F64)),
        "decompress_band": (
            lambda: jpeg_tpu_torch.decompress_band(data, cfg, F64, **cpu),
            lambda: jpeg_tpu.decompress_band(data, jcfg, F64)),
        "compress_ycbcr": (
            lambda: jpeg_tpu_torch.compress_ycbcr(img, cfg, F64, **cpu),
            lambda: jpeg_tpu.compress_ycbcr(img, jcfg, F64)),
        "compress_many": (
            lambda: jpeg_tpu_torch.compress_many([img, img2], cfg, F64, 1,
                                                 **cpu),
            lambda: jpeg_tpu.compress_many([img, img2], jcfg, F64, 1)),
        "decompress_to_ycbcr": (
            lambda: jpeg_tpu_torch.decompress_to_ycbcr(blob, F64, **cpu),
            lambda: jpeg_tpu.decompress_to_ycbcr(blob, F64)),
        "decompress_to_device": (
            lambda: jpeg_tpu_torch.decompress_to_device(blob, F64,
                                                        **cpu).numpy(),
            lambda: np.asarray(jpeg_tpu.decompress_to_device(blob, F64))),
        "decompress_many": (
            lambda: jpeg_tpu_torch.decompress_many([blob, blob2], F64, 3,
                                                   **cpu),
            lambda: jpeg_tpu.decompress_many([blob, blob2], F64, 3)),
        "Jpeg": (
            lambda: (lambda c: (c.compress(img), c.decompress(blob, F64,
                                                              **cpu)))(
                jpeg_tpu_torch.Jpeg(cfg, F64, **cpu)),
            lambda: (lambda c: (c.compress(img), c.decompress(blob, F64)))(
                jpeg_tpu.Jpeg(jcfg, F64))),
    }[name]


def _same(a, b):
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, bytes):
        return a == b
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", ["compress_band", "decompress_band",
                                  "compress_ycbcr", "compress_many",
                                  "decompress_to_ycbcr",
                                  "decompress_to_device", "decompress_many",
                                  "Jpeg"])
def test_reference_positional_form_gives_the_reference_result(name):
    ours, theirs = _positional_case(name)
    assert _same(ours(), theirs())


def test_positional_dtype_and_depth_in_the_f32_batch_decode():
    """``decompress_many(blobs, None, 4)``: the reference's positional
    (dtype, depth), the port's f32 path with its keyword device."""
    cfg, _ = _cfgs()
    blobs = [jpeg_tpu_torch.compress_ycbcr(_image(seed=s), cfg, device="cpu")
             for s in (1, 2, 3)]
    got = jpeg_tpu_torch.decompress_many(blobs, None, 4, device="cpu")
    want = [jpeg_tpu_torch.decompress_to_ycbcr(b, device="cpu")
            for b in blobs]
    assert _same(got, want)
    with pytest.raises(TypeError):
        jpeg_tpu_torch.decompress_many(blobs, None, 4, "cpu")
