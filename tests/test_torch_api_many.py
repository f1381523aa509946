"""jpeg_tpu_torch's batch, device-resident, band and image APIs vs
jpeg_tpu, mirroring tests/test_api_edge.py and tests/test_sized_encode.py.

``compress_many`` / ``decompress_many`` / ``decompress_to_device`` must
give exactly what their per-image counterparts give; ``compress_band`` /
``decompress_band`` and ``Jpeg`` agree with the JAX package's f32 path
except +-1 at provable ties (``jpeg_tpu/utils/parity.py``).  Here
``device="cpu"`` runs every kernel's plain PyTorch version.
"""
import sys
import threading

import numpy as np
import pytest
import torch

import jpeg_tpu
import jpeg_tpu.api as japi
from jpeg_tpu.utils import parity as jparity

import jpeg_tpu_torch
from jpeg_tpu_torch import BadStreamError, container
from jpeg_tpu_torch.container import CompressedData
from jpeg_tpu_torch.ops import kernels as K

torch.set_num_threads(2)


def _cfgs(h, w, qname="qtable", d=8, **q):
    return (jpeg_tpu_torch.Configuration(
                width=w, height=h, block_size=2, dct_size=d,
                quantization=jpeg_tpu_torch.QuantizationMethod(qname, **q)),
            jpeg_tpu.Configuration(
                width=w, height=h, block_size=2, dct_size=d,
                quantization=jpeg_tpu.QuantizationMethod(qname, **q)))


def _images(n, h, w, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            for _ in range(n)]


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_compress_many_matches_serial(depth):
    tcfg, _ = _cfgs(32, 48)
    imgs = _images(5, 32, 48)
    want = [jpeg_tpu_torch.compress_ycbcr(im, tcfg, device="cpu")
            for im in imgs]
    assert jpeg_tpu_torch.compress_many(imgs, tcfg, device="cpu",
                                        depth=depth) == want
    recon = jpeg_tpu_torch.decompress_many(want, device="cpu", depth=depth)
    for r, blob in zip(recon, want):
        np.testing.assert_array_equal(
            r, jpeg_tpu_torch.decompress_to_ycbcr(blob, device="cpu"))


def test_compress_many_edges():
    tcfg, _ = _cfgs(32, 48)
    with pytest.raises(ValueError, match="depth"):
        jpeg_tpu_torch.compress_many(_images(2, 32, 48), tcfg, device="cpu",
                                     depth=0)
    with pytest.raises(ValueError, match="depth"):
        jpeg_tpu_torch.decompress_many([], device="cpu", depth=0)
    assert jpeg_tpu_torch.compress_many([], tcfg, device="cpu") == []
    assert jpeg_tpu_torch.decompress_many([], device="cpu") == []
    # an image that fails stops the batch with its own error
    bad = _images(3, 32, 48)
    bad[1] = bad[1][:16]
    with pytest.raises(jpeg_tpu_torch.BadArrayShapeError):
        jpeg_tpu_torch.compress_many(bad, tcfg, device="cpu")


def test_compress_many_equals_the_jax_pipeline_except_ties():
    """The port's pipelined containers vs jpeg_tpu's compress_many (f32):
    byte-equal unless a level sits at a provable tie."""
    tcfg, jcfg = _cfgs(32, 32)
    imgs = _images(3, 32, 32, seed=11)
    got = jpeg_tpu_torch.compress_many(imgs, tcfg, device="cpu")
    want = japi.compress_many(imgs, jcfg, dtype=np.float32)
    for blob, jblob, im in zip(got, want, imgs):
        if blob == jblob:
            continue
        _, data = container.read_data(blob)
        _, jdata = jpeg_tpu.container.read_data(jblob)
        for b, (s, js) in enumerate(zip((data.y, data.cb, data.cr),
                                        (jdata.y, jdata.cb, jdata.cr))):
            _, ties = jparity.encode_reference_and_ties(jcfg, im[:, :, b])
            jparity.assert_tie_equal(
                jpeg_tpu.entropy.decode_levels(s, jcfg.num_blocks, 64),
                jpeg_tpu.entropy.decode_levels(js, jcfg.num_blocks, 64),
                ties, f"band {b}")


@pytest.mark.parametrize("scan", ["host", "device"])
def test_decompress_many_mixed_configs(scan):
    """The decode pipeline handles heterogeneous blobs (sizes, dct sizes
    and quantizers interleaved; jpeg_tpu encodes them, padded geometry
    included): each blob parses its own config."""
    rng = np.random.default_rng(9)
    blobs = []
    for w, h, d in [(32, 24, 8), (48, 48, 4), (32, 24, 8), (16, 16, 8)]:
        q = {} if d == 8 else {"divisor": 50}
        _, jcfg = _cfgs(h, w, "qtable" if d == 8 else "divide", d, **q)
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        blobs.append(jpeg_tpu.compress_ycbcr(img, jcfg, dtype=np.float32))
    recon = jpeg_tpu_torch.decompress_many(blobs, device="cpu", scan=scan,
                                           depth=2)
    for r, blob in zip(recon, blobs):
        np.testing.assert_array_equal(
            r, jpeg_tpu_torch.decompress_to_ycbcr(blob, device="cpu"))


@pytest.mark.parametrize("scan", ["host", "device"])
def test_decompress_to_device_matches_host_pull(scan):
    tcfg, _ = _cfgs(32, 48)
    blob = jpeg_tpu_torch.compress_ycbcr(_images(1, 32, 48, seed=12)[0],
                                         tcfg, device="cpu")
    dev = jpeg_tpu_torch.decompress_to_device(blob, device="cpu", scan=scan)
    assert torch.is_tensor(dev) and dev.device == torch.device("cpu")
    assert dev.shape == (3, 32, 48) and dev.dtype == torch.uint8
    np.testing.assert_array_equal(
        dev.numpy().transpose(1, 2, 0),
        jpeg_tpu_torch.decompress_to_ycbcr(blob, device="cpu"))


@pytest.mark.parametrize("scan", ["host", "device"])
def test_empty_container_body_raises_the_host_error(scan):
    """All three bands empty: the host scanner's BadStreamError, as
    jpeg_tpu raises, not an error of the stream upload."""
    tcfg, jcfg = _cfgs(32, 48)
    blob = container.generate_data(tcfg, CompressedData(b"", b"", b""))
    with pytest.raises(jpeg_tpu.config.BadStreamError):
        jpeg_tpu.decompress_to_ycbcr(blob, dtype=np.float32)
    with pytest.raises(BadStreamError):
        jpeg_tpu_torch.decompress_to_ycbcr(blob, device="cpu", scan=scan)


def test_band_roundtrip_agrees_with_jax_except_ties():
    tcfg, jcfg = _cfgs(32, 48)
    y, x = np.mgrid[0:32, 0:48]
    band = np.clip(128 + 80 * np.sin(x / 9.0) * np.cos(y / 7.0), 0,
                   255).astype(np.uint8)
    data = jpeg_tpu_torch.compress_band(band, tcfg, device="cpu")
    jdata = japi.compress_band(band, jcfg, dtype=np.float32)
    lv = jpeg_tpu.entropy.decode_levels(data, jcfg.num_blocks, 64)
    jlv = jpeg_tpu.entropy.decode_levels(jdata, jcfg.num_blocks, 64)
    _, ties = jparity.encode_reference_and_ties(jcfg, band)
    jparity.assert_tie_equal(lv, jlv, ties, "levels")
    rec = jpeg_tpu_torch.decompress_band(data, tcfg, device="cpu")
    want = japi.decompress_band(data, jcfg, dtype=np.float32)
    assert rec.shape == (32, 48) and rec.dtype == want.dtype == np.int32
    _, dties = jparity.decode_reference_and_ties(jcfg, lv)
    jparity.assert_tie_equal(rec, want, dties, "plane")
    assert jpeg_tpu_torch.psnr(band, rec) > 30.0
    with pytest.raises(jpeg_tpu_torch.BadArrayShapeError):
        jpeg_tpu_torch.compress_band(band[:16], tcfg, device="cpu")


def test_jpeg_class_roundtrip():
    tcfg, jcfg = _cfgs(32, 48)
    img = _images(1, 32, 48, seed=4)[0]
    codec = jpeg_tpu_torch.Jpeg(tcfg, device="cpu")
    blob = codec.compress(img)
    assert blob == jpeg_tpu_torch.compress_ycbcr(img, tcfg, device="cpu")
    rec = np.asarray(jpeg_tpu_torch.Jpeg.decompress(blob, device="cpu"))
    np.testing.assert_array_equal(
        rec, jpeg_tpu_torch.decompress_to_ycbcr(blob, device="cpu"))
    jrec = np.asarray(jpeg_tpu.Jpeg.decompress(blob, dtype=np.float32))
    assert rec.shape == jrec.shape == img.shape
    _, data = container.read_data(blob)
    for b, s in enumerate((data.y, data.cb, data.cr)):
        lv = jpeg_tpu.entropy.decode_levels(s, jcfg.num_blocks, 64)
        _, ties = jparity.decode_reference_and_ties(jcfg, lv)
        jparity.assert_tie_equal(rec[:, :, b], jrec[:, :, b], ties,
                                 f"band {b}")


def test_jpeg_decompress_returns_an_array_without_pil(monkeypatch):
    tcfg, _ = _cfgs(32, 48)
    blob = jpeg_tpu_torch.compress_ycbcr(_images(1, 32, 48)[0], tcfg,
                                         device="cpu")
    monkeypatch.setitem(sys.modules, "PIL", None)     # import PIL fails
    out = jpeg_tpu_torch.Jpeg.decompress(blob, device="cpu", scan="device")
    assert isinstance(out, np.ndarray) and out.shape == (32, 48, 3)
    np.testing.assert_array_equal(
        out, jpeg_tpu_torch.decompress_to_ycbcr(blob, device="cpu"))


def test_launch_counts_survive_concurrent_threads():
    """The pipelined API launches kernels from its worker thread as well as
    the caller's: concurrent counts lose no update."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        K.reset_launch_counts()
        threads = [threading.Thread(
            target=lambda: [K._count(K.scan_walk) for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert K.launch_counts()["scan_walk"] == 16 * 2000
    finally:
        sys.setswitchinterval(old)
        K.reset_launch_counts()
