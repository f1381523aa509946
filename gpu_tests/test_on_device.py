"""On-device tests: the port's production path on an NVIDIA GPU.

Counterpart of ``tpu_tests/test_on_device.py``, case by case, on
``device="cuda"``: the hand-written kernels (``jpeg_tpu_torch/csrc``,
built at first use), the f32 defaults and device entropy coding in both
directions.  The JAX package's environment flags map to the port's keyword
arguments: ``JPEG_TPU_SCAN`` to ``scan=``, ``JPEG_TPU_ENC_TABLES`` to
``enc=``, ``JPEG_TPU_HOST_ENTROPY`` to the host codec called directly,
x64 to ``dtype=torch.float64``.  Beside them: the sharded entry points of
``parallel`` on meshes of the one GPU, at padded heights too, the tables
encoder (K9) and the two-sweep end table (K6').  Together the cases launch
all ten kernels; each kernel's own check against its plain version is
``chip_smoke.py``'s phase 3.

The suite imports torch, numpy, pytest and ``jpeg_tpu_torch`` only, so it
runs where JAX is absent.  From the root of the repository:

    python -m pytest gpu_tests -q -o addopts= -p no:cacheprovider

(``-o addopts=`` drops ``pytest.ini``'s xdist option, which this suite
does not need).  ``chip_smoke.py`` runs it (phase 4g) and fails on any
failure or skip.  Without a CUDA device every case skips (``conftest.py``).
"""
import gc
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from jpeg_tpu_torch import (Configuration, QuantizationMethod, api,
                            compress_band, compress_many, compress_ycbcr,
                            container, decompress_band, decompress_many,
                            decompress_to_device, decompress_to_ycbcr,
                            entropy, parallel, psnr)
from jpeg_tpu_torch.container import CompressedData
from jpeg_tpu_torch.entropy import device_codec as DC
from jpeg_tpu_torch.entropy import device_scan as DS
from jpeg_tpu_torch.ops import band as band_ops
from jpeg_tpu_torch.ops import blocks as B
from jpeg_tpu_torch.ops import kernels as K
from jpeg_tpu_torch.ops import quantize as Q
from jpeg_tpu_torch.ops import transform as T
from jpeg_tpu_torch.ops.band import BandDecoder, BandEncoder
from jpeg_tpu_torch.parallel import sharded
from jpeg_tpu_torch.utils import parity

DEV = torch.device("cuda", 0)
F64 = torch.float64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
with open(os.path.join(GOLDEN, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
# Seeded draws of ragged geometries and quantizers: the f32 tie campaign
# in small.
CAMPAIGN_DRAWS = 30

pytestmark = pytest.mark.filterwarnings(
    "ignore:dimension of size:UserWarning")


@pytest.fixture(scope="module")
def img():
    y, x = np.mgrid[0:96, 0:128].astype(np.float64)
    plane = np.clip(128 + 70 * np.sin(x / 11.0) * np.cos(y / 13.0), 0, 255)
    return np.repeat(plane[:, :, None], 3, axis=2).astype(np.uint8)


def _cfg(**kw):
    kw.setdefault("width", 128)
    kw.setdefault("height", 96)
    kw.setdefault("block_size", 2)
    kw.setdefault("dct_size", 8)
    kw.setdefault("quantization", QuantizationMethod("qtable"))
    return Configuration(**kw)


def _synth(h, w, seed=0):
    """(H, W, 3) uint8 image: smooth bands plus noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    bands = [128 + 70 * np.sin(x / (9 + 4 * c)) * np.cos(y / (13 - 3 * c))
             + 12 * rng.standard_normal((h, w)) for c in range(3)]
    return np.clip(np.stack(bands, -1), 0, 255).astype(np.uint8)


def _golden_image(h, w):
    """The generator of the ``tests/golden`` blobs' images (seed 42)."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    rng = np.random.default_rng(42)
    img = np.stack([128 + 70 * np.sin(x / 13) * np.cos(y / 11),
                    128 + 50 * np.cos(x / 7),
                    np.clip(8 * rng.standard_normal((h, w)) + 128, 0, 255)],
                   -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def _launched(fn):
    """``fn()`` and the kernel launches it made."""
    K.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, K.launch_counts()


def _encode(cfg, band):
    x = torch.from_numpy(np.ascontiguousarray(band)).to(DEV)[None]
    return BandEncoder(cfg).to(DEV)(x)[0].cpu().numpy()


def _decode(cfg, levels):
    lv = torch.from_numpy(np.ascontiguousarray(levels)).to(DEV)[None]
    return BandDecoder(cfg).to(DEV)(lv)[0].cpu().numpy()


def _check_tie_contract(cfg, band, monkeypatch):
    """The f32 band modules on the card vs the f64 oracle under the
    +-1-at-provable-ties contract (``utils/parity.py``): their kernel
    branch (K5 on DFT at padded geometry, K4 wherever the dequantizer is an
    integer), and the same modules with each kernel's plain version, a
    cuBLAS f32 product, in its place where a branch has a kernel."""
    band = np.asarray(band, np.int32)
    K.reset_launch_counts()
    lv = _encode(cfg, band)
    px = _decode(cfg, lv)
    counts = K.launch_counts()
    ref, et = parity.encode_reference_and_ties(cfg, band)
    parity.assert_tie_equal(lv, ref, et, "encode vs f64")
    pref, dt = parity.decode_reference_and_ties(cfg, lv)
    parity.assert_tie_equal(px, pref, dt, "decode vs f64")
    k5 = BandEncoder(cfg).branch == "blocks"
    k4 = BandDecoder(cfg).branch == "kernel"
    assert (counts["encode_blocks"] > 0, counts["decode_blocks"] > 0) == \
        (k5, k4), counts
    if k5 or k4:
        with monkeypatch.context() as m:
            m.setattr(K, "encode_blocks", K.encode_blocks_plain)
            m.setattr(K, "decode_blocks", K.decode_blocks_plain)
            lv_c, px_c = _encode(cfg, band), _decode(cfg, lv)
        parity.assert_tie_equal(lv_c, ref, et, "encode cuBLAS vs f64")
        parity.assert_tie_equal(px_c, pref, dt, "decode cuBLAS vs f64")


# K4's inflate store: (d, bs, N) of each case.  N = 2,760 and 24,480 are a
# padded 4K frame's three bands at d 24 and d 8, bs 4 (the benchmark's
# cells); no N is a multiple of a tile's 64 or 128 rows.
K4_INFLATE_CASES = {
    "d8_bs4": (8, 4, 1001), "d24_bs4": (24, 4, 1001), "d24_bs2": (24, 2, 999),
    "d8_bs1": (8, 1, 1001), "d24_bs1": (24, 1, 333),
    "ragged_d8_bs3": (8, 3, 777), "ragged_d5_bs2": (5, 2, 501),
    "ragged_d3_bs3": (3, 3, 65), "4k_d24_bs4": (24, 4, 2760),
    "4k_d8_bs4": (8, 4, 24480)}


@pytest.mark.parametrize("transform", ["DCT", "DFT"])
@pytest.mark.parametrize("case", sorted(K4_INFLATE_CASES))
def test_k4_inflate_store_bit_equal_to_the_combined_operator_on_chip(
        case, transform):
    """K4 on the d*d decode operator, writing each pixel to its bs x bs
    places, against K4 at bs 1 on the ((d*bs)**2, d*d) combined operator,
    which computes every replica: equal byte for byte (one launch each).
    Against its plain version (full-f32 cuBLAS, then the inflate): equal
    except +-1 where the exact sum lies within (K + 16) 2**-23 sum|terms|
    of a .5 tie.  Levels are random within the cells' ranges (saturating
    blocks among them), the dequantizer the cells' (qtable at d 8, divide
    1000 at d 24) or, elsewhere, divide 40."""
    d, bs, n = K4_INFLATE_CASES[case]
    L = d * d
    rng = np.random.default_rng(sum(map(ord, case + transform)))
    lv = np.where(rng.random((n, L)) < 0.3, rng.integers(-40, 41, (n, L)), 0)
    lv[:, 0] = rng.integers(-300, 301, n)
    lv[1, 0], lv[2, 0] = 16383, -16383
    q = (QuantizationMethod("qtable") if d == 8 and transform == "DCT" else
         QuantizationMethod("divide", divisor=1000 if d == 24 else 40))
    deq = torch.from_numpy(Q.dequant_int_vector(q, d).astype(np.int32)).to(
        DEV)
    lv = torch.from_numpy(lv.astype(np.int32)).to(DEV)
    dec = (T.decode_operator if transform == "DCT" else
           T.dft_decode_operator)(d)
    op_t = torch.from_numpy(np.ascontiguousarray(dec.T, np.float32)).to(DEV)
    comb_t = torch.from_numpy(np.ascontiguousarray(
        T.combined_decode_operator(d, bs, transform).T, np.float32)).to(DEV)
    new, counts = _launched(lambda: K.decode_blocks(lv, op_t, deq, bs=bs))
    old, counts_old = _launched(lambda: K.decode_blocks(lv, comb_t, deq))
    assert counts["decode_blocks"] == counts_old["decode_blocks"] == 1
    assert new.shape == old.shape == (n, L * bs * bs)
    assert torch.equal(new, old), int((new != old).sum())
    plain = K.decode_blocks_plain(lv, op_t, deq, bs=bs)
    a64 = (lv * deq).to(torch.float32).double()
    v = a64 @ op_t.double()
    terms = a64.abs() @ op_t.double().abs()
    ties = (v - v.floor() - 0.5).abs() <= (L + 16) * parity.EPS32 * terms
    ties = K.inflate_blocks(ties.to(torch.uint8), bs).bool()
    parity.assert_tie_equal(new.cpu().numpy(), plain.cpu().numpy(),
                            ties.cpu().numpy(), f"K4 vs plain {case}")


def test_k4_once_and_one_inflate_store_in_a_4k_d24_decode_on_chip():
    """A 3840x2160 d 24 container (bs 4, divide 1000: the benchmark's d 24
    configuration) through ``decompress_to_ycbcr()``: one K4 launch and one
    ``band.inflate_store``, and the planes of the plain-version path."""
    from jpeg_tpu_torch.utils import profiling
    cfg = _cfg(height=2160, width=3840, dct_size=24, block_size=4,
               quantization=QuantizationMethod("divide", divisor=1000))
    blob = compress_ycbcr(_synth(2160, 3840, seed=37), cfg)
    decompress_to_ycbcr(blob)
    profiling.start_recording()
    try:
        got, counts = _launched(lambda: decompress_to_ycbcr(blob))
    finally:
        profiling.stop_recording()
    assert counts["decode_blocks"] == 1, counts
    assert profiling.recorded().counts.get("band.inflate_store") == 1
    # 920 blocks a band: K6 + K8's short form, not the segmented scan
    assert profiling.recorded().counts.get("scan.segmented", 0) == 0
    assert counts["segment_scan"] == 0 and counts["scan_walk"] == 1
    with pytest.MonkeyPatch.context() as m:
        m.setattr(K, "decode_blocks", K.decode_blocks_plain)
        want = decompress_to_ycbcr(blob)
    assert got.shape == want.shape == (2160, 3840, 3)
    assert int(np.abs(got.astype(np.int16) - want).max()) <= 1


def test_full_chroma_24mp_decode_to_device_on_chip():
    """A 6000x4000 bs 1 d 8 qtable container (the benchmark's
    photo24mp_444 configuration) through ``decompress_to_device(scan=
    "device")``: every plane within the tie contract of the f64 decode of
    the container's levels; the segmented scan (K10) counted once, with
    its segments and at most one in a thousand unsynced, neither K6 nor
    K8 launched (K8's long form no longer runs in a decode), no inflate
    store, and ``decode.stream_bytes`` the container's band bytes."""
    from jpeg_tpu_torch.utils import profiling
    cfg = _cfg(height=4000, width=6000, block_size=1)
    blob = compress_ycbcr(_synth(4000, 6000, seed=24), cfg)
    decompress_to_device(blob, scan="device")
    profiling.start_recording()
    try:
        planes, launches = _launched(
            lambda: decompress_to_device(blob, scan="device"))
    finally:
        profiling.stop_recording()
    counts = profiling.recorded().counts
    spans = container.read_band_spans(blob)[1]
    assert counts.get("scan.segmented") == 1, counts
    assert launches["segment_scan"] == 1, launches
    assert launches["scan_walk"] == 0 and launches["chase_starts_multi"] == 0
    segments = sum(K.segment_counts([0] * 3, [n for _, n in spans],
                                    K.SEGMENT_BYTES))
    assert counts.get("scan.segments") == segments, counts
    assert 0 <= counts["scan.segments_unsynced"] <= segments // 1000
    assert counts.get("band.inflate_store", 0) == 0, counts
    assert counts.get("decode.stream_bytes") == sum(n for _, n in spans)
    got = planes.cpu().numpy()
    assert got.shape == (3, 4000, 6000)
    _, data = container.read_data(blob)
    for b, stream in enumerate((data.y, data.cb, data.cr)):
        lv = entropy.decode_levels(stream, cfg.num_blocks, 64)
        want, ties = parity.decode_reference_and_ties(cfg, lv)
        parity.assert_tie_equal(got[b].astype(np.int32), want, ties,
                                f"band {b} vs f64")


def _photo_bands(h, w, seed):
    """A bs 1 d 8 qtable container's bands as a decode moves them: (bytes
    from the first band's first byte to the last band's end, firsts, ends,
    blocks a band)."""
    cfg = _cfg(height=h, width=w, block_size=1)
    blob = compress_ycbcr(_synth(h, w, seed=seed), cfg)
    spans = container.read_band_spans(blob)[1]
    base = spans[0][0]
    firsts = [pos - base for pos, _ in spans]
    ends = [first + n for first, (_, n) in zip(firsts, spans)]
    return bytes(blob[base:base + ends[-1]]), firsts, ends, cfg.num_blocks


def _malformed(raw, firsts, ends, count, seed):
    """``count`` malformed copies of the bands, (bytes, ends): bits
    flipped, 32 bytes overwritten, a band 1-4 bytes short, a band run 2
    bytes into the next length field, a band's first byte garbled."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        r, e = bytearray(raw), list(ends)
        b = int(rng.integers(len(firsts)))
        kind = i % 5
        if kind == 0:
            for _ in range(int(rng.integers(1, 4))):
                r[int(rng.integers(firsts[b], ends[b]))] ^= \
                    1 << int(rng.integers(8))
        elif kind == 1:
            j = int(rng.integers(firsts[b], ends[b] - 32))
            r[j:j + 32] = bytes(rng.integers(0, 256, 32).tolist())
        elif kind == 2:
            e[b] -= int(rng.integers(1, 5))
        elif kind == 3:
            e[b] += 2 if b + 1 < len(firsts) else -1
        else:
            r[firsts[b]] ^= 0x5A
        out.append((bytes(r), e))
    return out


def _on_chip(raw):
    return torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(DEV)


def test_segmented_scan_bit_equal_to_k6_k8_on_chip():
    """The segmented scan (K10) against K6 + K8 on a 6000x4000 bs 1
    photo's three bands (375,000 blocks each) and 20 malformed copies of
    them: the same check everywhere and the same starts where it holds, at
    the wrapper's segment length through ``scan_bands_segmented`` (one K10
    launch, no K6 or K8) and at 256 bytes."""
    raw, firsts, ends, nb = _photo_bands(4000, 6000, seed=25)
    assert nb == 375_000
    cases = [(raw, ends)] + _malformed(raw, firsts, ends, 20, seed=2500)
    held = 0
    for i, (r, e) in enumerate(cases):
        stream = _on_chip(r)
        want, ok = DS.scan_bands_starts(stream, e, nb, 64, firsts)
        ok = bool(ok)
        held += ok
        (got, status), counts = _launched(
            lambda: DS.scan_bands_segmented(stream, e, nb, 64, firsts))
        assert counts["segment_scan"] == 1 and counts["scan_walk"] == 0
        assert counts["chase_starts_multi"] == 0
        assert (int(status[0]) == 0) == ok, (i, status.tolist())
        assert not ok or torch.equal(got, want), i
        got, status = K.segment_scan(stream, firsts, e, nb, 64, 256)
        assert (int(status[0]) == 0) == ok, (i, status.tolist())
        assert not ok or torch.equal(got, want), i
    assert held >= 1


@pytest.mark.parametrize("seg", [32, 64, 1024])
def test_segmented_scan_equals_its_plain_version_on_chip(seg):
    """K10 against its plain version on a 240x320 bs 1 photo's bands and
    five malformed copies: the starts and the status (rejected bands,
    unsynced walkers) bit for bit, at segment lengths under a block and
    over the longest band."""
    raw, firsts, ends, nb = _photo_bands(240, 320, seed=seg)
    for r, e in [(raw, ends)] + _malformed(raw, firsts, ends, 5, seed=seg):
        stream = _on_chip(r)
        got = K.segment_scan(stream, firsts, e, nb, 64, seg)
        want = K.segment_scan_plain(stream.cpu(), firsts, e, nb, 64, seg)
        assert torch.equal(got[1].cpu(), want[1]), (got[1], want[1])
        assert torch.equal(got[0].cpu(), want[0])


def _host_entropy_container(img, cfg):
    """The container with every band's levels pulled and coded by the host
    codec (the JAX package's ``JPEG_TPU_HOST_ENTROPY``)."""
    x = torch.from_numpy(img).to(DEV).permute(2, 0, 1)
    lv = BandEncoder(cfg).to(DEV)(x).cpu().numpy()
    return container.generate_data(cfg, CompressedData(
        *(entropy.encode_levels(b) for b in lv)))


def test_kernel_branch_matches_f64_tie_contract(img, monkeypatch):
    _check_tie_contract(_cfg(), img[:, :, 0], monkeypatch)


@pytest.mark.parametrize("d,transform,bs", [
    (24, "DCT", 2),   # BASELINE config 3 family: K4 at K = 576
    (8, "DFT", 2),    # dyadic-rational operator: tie-dense, K5
    (8, "DCT", 3),    # non-power-of-two subsample divisor
])
def test_ragged_combined_decode_on_chip(d, transform, bs, monkeypatch):
    rng = np.random.default_rng(1000 * d + bs)
    w, h = d * 2 * 5 + 3, d * 2 * 3 + 1
    cfg = Configuration(width=w, height=h, block_size=bs, dct_size=d,
                        transform=transform,
                        quantization=QuantizationMethod("divide", divisor=40))
    _check_tie_contract(cfg, rng.integers(0, 256, (h, w)), monkeypatch)


def _campaign_draw(k):
    """Draw k: ragged height and width, any transform and quantizer (a
    non-integer divisor only where its f32 product is exact, the contract's
    scope)."""
    rng = np.random.default_rng(7700 + k)
    d = int(rng.choice([2, 3, 4, 8, 8, 24]))
    bs = int(rng.integers(1, 5))
    D = d * bs
    h = D * int(rng.integers(0, 4)) + int(rng.integers(1, D))
    w = D * int(rng.integers(0, 4)) + int(rng.integers(1, D))
    qs = [("none", {}), ("divide", {"divisor": int(rng.choice([3, 40,
                                                                1000]))}),
          ("divide", {"divisor": 2.5}),
          ("discard", {"keep": int(rng.integers(1, d + 1))})]
    if d == 8:
        qs.append(("qtable", {}))
    qname, qp = qs[int(rng.integers(len(qs)))]
    cfg = Configuration(width=w, height=h, block_size=bs, dct_size=d,
                        transform=str(rng.choice(["DCT", "DFT"])),
                        quantization=QuantizationMethod(qname, **qp))
    return cfg, rng.integers(0, 256, (h, w))


@pytest.mark.parametrize("k", range(CAMPAIGN_DRAWS))
def test_ragged_tie_campaign_on_chip(k, monkeypatch):
    cfg, band = _campaign_draw(k)
    _check_tie_contract(cfg, band, monkeypatch)


def test_roundtrip_quality_and_entropy_modes(img):
    cfg = _cfg()
    blob_dev, counts = _launched(lambda: compress_ycbcr(img, cfg))
    assert counts["encode_stream_rows"] > 0 and counts["deposit_rows"] > 0
    assert blob_dev == _host_entropy_container(img, cfg)
    out_dev, counts = _launched(lambda: decompress_to_ycbcr(blob_dev))
    assert counts["decode_stream_blocks"] > 0 and counts["decode_blocks"] > 0
    _, data = container.read_data(blob_dev)
    # host bit parsing: the host codec's levels, the coefficient decode
    # on the card
    out_host = np.stack([decompress_band(s, cfg) for s in
                         (data.y, data.cb, data.cr)], -1)
    np.testing.assert_array_equal(out_dev, out_host)
    assert psnr(img, out_dev) > 30


def test_fast_mode_matches_parity_decode(img):
    """The f32 decode on the card equals the f64 parity decode exactly;
    the port's f64 runs in process."""
    blob = compress_ycbcr(img, _cfg())
    fast = decompress_to_ycbcr(blob)
    exact = decompress_to_ycbcr(blob, F64)
    assert hashlib.sha256(fast.tobytes()).hexdigest() == \
        hashlib.sha256(exact.tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_golden_blob_reproduced_in_f64_on_chip(name):
    """In place of the JAX-only x64 check: the f64 parity mode on the card
    reproduces each golden blob byte for byte, and its decode (both scans)
    the recorded plane hash."""
    kw = dict(MANIFEST[name]["config"])
    q = kw.pop("quantization", None)
    cfg = Configuration(**kw, quantization=QuantizationMethod(
        q["name"], **q["params"]) if q else None)
    with open(os.path.join(GOLDEN, f"{name}.jc"), "rb") as f:
        want = f.read()
    blob = compress_ycbcr(_golden_image(cfg.height, cfg.width), cfg, F64)
    assert blob == want
    for scan in ("host", "device"):
        out = decompress_to_ycbcr(want, F64, scan=scan)
        assert hashlib.sha256(out.tobytes()).hexdigest() == \
            MANIFEST[name]["decoded_sha256"]


def test_exotic_configs_roundtrip(img):
    for cfg in [
        _cfg(transform="DFT", quantization=QuantizationMethod("none")),
        _cfg(dct_size=24, block_size=4,
             quantization=QuantizationMethod("divide", divisor=1000)),
        _cfg(dct_size=4, block_size=1,
             quantization=QuantizationMethod("discard", keep=2)),
    ]:
        out = decompress_to_ycbcr(compress_ycbcr(img, cfg))
        assert out.shape == img.shape
        assert psnr(img, out) > 15


def test_dft_kernel_matches_cublas_on_chip(img, monkeypatch):
    """The DFT at divisible geometry (the joint cuBLAS product), and K5 on
    the same image's pixel blocks against the cuBLAS f32 product and the
    f64 oracle, under the tie contract."""
    cfg = _cfg(transform="DFT", quantization=QuantizationMethod("none"))
    band = img[:, :, 0].astype(np.int32)
    _check_tie_contract(cfg, band, monkeypatch)
    d = cfg.dct_size
    sub = B.subsample_fast_hw(torch.from_numpy(band).to(DEV),
                              cfg.block_size)
    vecs = B.blockify(sub, d).reshape(-1, d * d).contiguous()
    op_t = torch.tensor(T.dft_encode_operator(d).T, dtype=torch.float32,
                        device=DEV).contiguous()
    vec_np = [np.asarray(v, np.float64) for v in
              Q.epilogue_vectors(cfg.quantization, d)]
    mul, div, mask = (torch.tensor(v, dtype=torch.float32, device=DEV)
                      for v in vec_np)
    lv, counts = _launched(lambda: K.encode_blocks(vecs, op_t, mul, div,
                                                   mask).cpu().numpy())
    assert counts["encode_blocks"] == 1
    cublas = K.encode_blocks_plain(vecs, op_t, mul, div, mask).cpu().numpy()
    ref, ties = parity.blocks_reference_and_ties(
        vecs.double().cpu().numpy(), T.dft_encode_operator(d), *vec_np)
    parity.assert_tie_equal(lv, ref, ties, "K5 vs f64")
    parity.assert_tie_equal(cublas, ref, ties, "cuBLAS vs f64")
    parity.assert_tie_equal(lv, cublas, ties, "K5 vs cuBLAS")


def test_foreign_decode_one_dispatch_on_chip(img):
    """The host-free decode (device scan K6 + K8, then K3, K4) reproduces
    the host-scan path bit for bit."""
    blob = compress_ycbcr(img, _cfg())
    base = decompress_to_ycbcr(blob, scan="host")
    got, counts = _launched(lambda: decompress_to_ycbcr(blob, scan="device"))
    assert counts["scan_walk"] > 0 and counts["chase_starts_multi"] > 0
    np.testing.assert_array_equal(got, base)


def test_device_decode_without_native_codec(img, monkeypatch):
    """With no C++ codec the decode is unchanged: the auto scan takes the
    device scan, as it does with one, and gives the host scan's image."""
    blob = compress_ycbcr(img, _cfg())
    want = decompress_to_ycbcr(blob, scan="host")
    monkeypatch.setattr(entropy, "_native", None)
    monkeypatch.setattr(entropy, "_native_checked", True)
    got, counts = _launched(lambda: decompress_to_ycbcr(blob))
    np.testing.assert_array_equal(got, want)
    assert counts["decode_stream_blocks"] > 0 and counts["decode_blocks"] > 0


def test_pipelined_many_matches_serial_on_chip(img):
    cfg = _cfg()
    flipped = img[:, :, ::-1].copy()
    blobs = compress_many([img, flipped], cfg)
    assert blobs[0] == compress_ycbcr(img, cfg)
    assert blobs[1] == compress_ycbcr(flipped, cfg)
    recon = decompress_many(blobs)
    np.testing.assert_array_equal(recon[0], decompress_to_ycbcr(blobs[0]))
    np.testing.assert_array_equal(recon[1], decompress_to_ycbcr(blobs[1]))


def test_decompress_plane_on_chip(img):
    cfg = _cfg()
    mesh = parallel.make_mesh(1)
    plane = img[:, :, 0].astype(np.int32)
    stream = compress_band(plane, cfg)
    got = parallel.decompress_plane(stream, cfg, mesh, device_entropy=True)
    np.testing.assert_array_equal(got, decompress_band(stream, cfg))


def test_long_run_encode_on_chip():
    """K1 with zero runs past a 55-bit group (L = 144: up to 9 chain
    bytes) and K2 give the host codec's bytes; K3 returns the levels."""
    rng = np.random.default_rng(5)
    L = 144
    lv = np.zeros((96, L), np.int32)
    mask = rng.random(lv.shape) < 0.04          # sparse: long runs abound
    lv[mask] = rng.integers(-16383, 16384, int(mask.sum()))
    lv[1] = 0
    lv[1, L - 1] = 5                            # maximal 143-zero run
    lv[2] = 0
    lv[2, 0] = -3                               # trailing zeros dropped
    lv[3] = 0
    lv[3, 75] = 7
    lv[3, L - 1] = -9                           # two long runs, one block
    want = entropy.encode_levels(lv)
    lv_t = torch.from_numpy(lv).to(DEV)
    bb = DC.block_bytes_of(lv_t)
    (buf, _, bad), counts = _launched(lambda: DC.encode_stream_sized(
        lv_t, -(-int(bb.max()) // 4), int(bb.sum()) + 64))
    assert counts["encode_stream_rows"] == 1 and counts["deposit_rows"] == 1
    DC.check_sized_ok(bad.cpu())
    buf = buf.cpu().numpy()
    assert buf[:len(want)].tobytes() == want
    assert not buf[len(want):].any()
    starts = entropy.scan_offsets(want, lv.shape[0], L, scan="host")
    got = DC.decode_stream(DC.upload_stream(want, DEV),
                           torch.from_numpy(starts).to(DEV), L)
    np.testing.assert_array_equal(got.cpu().numpy(), lv)


def test_sized_encode_on_chip(img):
    """The two-phase content-sized encode equals the host-entropy
    container."""
    cfg = _cfg(height=88, width=120)
    im = _synth(88, 120, seed=3)
    assert compress_ycbcr(im, cfg) == _host_entropy_container(im, cfg)


def _word_rows(rng, n, W, lens):
    """(n, W) int32 rows of big-endian words holding ``lens[i]`` random
    nonzero bytes each, zero past them."""
    b = np.zeros((n, 4 * W), np.uint32)
    keep = np.arange(4 * W)[None, :] < lens[:, None]
    b[keep] = rng.integers(1, 256, int(keep.sum()))
    sh = (24 - 8 * (np.arange(4 * W) % 4)).astype(np.uint32)
    return np.bitwise_or.reduce((b << sh).reshape(n, W, 4),
                                axis=2).astype(np.uint32).view(np.int32)


def test_merge_kernel_matches_plain_on_chip():
    """K2 equals its plain version on random rows and lengths, and on a
    tile of empty blocks."""
    rng = np.random.default_rng(7)
    n, W = 3 * K.DEPOSIT_TILE_BLOCKS + 5, 16
    lens = rng.integers(0, 4 * W + 1, n).astype(np.int32)
    lens[K.DEPOSIT_TILE_BLOCKS:2 * K.DEPOSIT_TILE_BLOCKS] = 0
    rows = torch.from_numpy(_word_rows(rng, n, W, lens)).to(DEV)
    bb = torch.from_numpy(lens).to(DEV)
    for cap in (int(lens.sum()), int(lens.sum()) + 37, int(lens.sum()) // 2):
        got, counts = _launched(lambda: K.deposit_rows(rows, bb, cap))
        assert counts["deposit_rows"] == 1
        assert torch.equal(got, K.deposit_rows_plain(rows, bb, cap))
    empty = torch.zeros(K.DEPOSIT_TILE_BLOCKS, dtype=torch.int32, device=DEV)
    got = K.deposit_rows(rows[:K.DEPOSIT_TILE_BLOCKS], empty, 64)
    assert torch.equal(got, torch.zeros(64, dtype=torch.uint8, device=DEV))


def test_device_scan_on_chip():
    """The device scan (K6, K7) equals the C++ scan; a truncated stream is
    rejected."""
    rng = np.random.default_rng(11)
    nb, L = 700, 64
    lv = np.zeros((nb, L), np.int32)
    m = rng.random(lv.shape) < 0.15
    lv[m] = rng.integers(-2000, 2000, int(m.sum()))
    data = entropy.encode_levels(lv)
    (starts, ok), counts = _launched(
        lambda: DS.scan_offsets_device(data, nb, L, DEV))
    assert ok and counts["scan_walk"] == 1 and counts["chase_starts"] == 1
    np.testing.assert_array_equal(
        starts, entropy.scan_offsets(data, nb, L, scan="host"))
    _, ok_bad = DS.scan_offsets_device(data[:-1], nb, L, DEV)
    assert not ok_bad


def test_words_interchange_on_chip():
    """K1 -> K2 -> K3 on the card, the starts from the encoder's own byte
    counts."""
    rng = np.random.default_rng(5)
    nb, L = 900, 64
    lv = np.zeros((nb, L), np.int32)
    m = rng.random(lv.shape) < 0.2
    lv[m] = rng.integers(-2000, 2000, int(m.sum()))
    lv_t = torch.from_numpy(lv).to(DEV)
    bb0 = DC.block_bytes_of(lv_t)
    W, cap = -(-int(bb0.max()) // 4), int(bb0.sum())

    def roundtrip():
        buf, b, bad = DC.encode_stream_sized(lv_t, W, cap)
        b = b.to(torch.int64)
        return buf, b, bad, DC.decode_stream(buf, torch.cumsum(b, 0) - b, L)

    (buf, b, bad, got), counts = _launched(roundtrip)
    assert all(counts[n] == 1 for n in ("encode_stream_rows", "deposit_rows",
                                        "decode_stream_blocks"))
    DC.check_sized_ok(bad.cpu())
    assert buf.cpu().numpy().tobytes() == entropy.encode_levels(lv)
    np.testing.assert_array_equal(got.cpu().numpy(), lv)


# ---------------------------------------------------------------------------
# The sharded entry points on meshes of the one GPU (phase 4f's cases)
# ---------------------------------------------------------------------------

def _band_mesh(n):
    return parallel.make_mesh(devices=[DEV] * n, data=1, band=n)


@pytest.mark.parametrize("n", [1, 4])
def test_sharded_entry_points_on_chip(n):
    mesh = _band_mesh(n)
    h, w = 256, 384
    cfg = _cfg(height=h, width=w)
    batch = np.stack([_synth(h, w, seed=s) for s in range(3)])
    assert len(sharded.batch_shares(mesh, cfg, len(batch))) == n
    ref = [compress_ycbcr(im, cfg) for im in batch]
    want = [decompress_to_ycbcr(b) for b in ref]
    for de in (True, False):
        assert parallel.compress_batch(batch, cfg, mesh,
                                       device_entropy=de) == ref
        rec = parallel.decompress_batch(ref, mesh, device_entropy=de)
        for r, x in zip(rec, want):
            np.testing.assert_array_equal(r, x)
    plane = batch[0, :, :, 0]
    serial = compress_band(plane, cfg)
    assert parallel.compress_plane(plane, cfg, mesh) == serial
    got, counts = _launched(
        lambda: parallel.compress_plane_device_entropy(plane, cfg, mesh))
    assert got == serial
    assert counts["encode_stream_rows"] == counts["deposit_rows"] == n
    got, counts = _launched(lambda: parallel.decompress_plane(
        serial, cfg, mesh, device_entropy=True))
    np.testing.assert_array_equal(got, decompress_band(serial, cfg))
    assert counts["decode_stream_blocks"] == counts["decode_blocks"] == n


@pytest.mark.parametrize("h,w,transform,qname", [
    (120, 64, "DCT", "none"), (120, 64, "DFT", "none"),
    (120, 64, "DCT", "qtable"), (120, 64, "DFT", "qtable"),
    (2040, 2048, "DCT", "none"), (2040, 2048, "DFT", "qtable"),
])
def test_sharded_padded_height_bytes_equal_serial_on_chip(h, w, transform,
                                                          qname):
    """A padded height with a divisible width, f32, on a 1 x 4 mesh: the
    three shares above the padded edge run the whole image's branch, and
    the sharded bytes and planes equal the serial ones."""
    cfg = _cfg(height=h, width=w, transform=transform,
               quantization=QuantizationMethod(qname))
    D = cfg.dct_size * cfg.block_size
    assert h % D and w % D == 0 and cfg.blocks_high % 4 == 0
    mesh = _band_mesh(4)
    rng = np.random.default_rng(h + w)
    im = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    plane = im[:, :, 0]
    serial = compress_band(plane, cfg)
    assert parallel.compress_plane(plane, cfg, mesh) == serial
    assert parallel.compress_plane_device_entropy(plane, cfg, mesh) == serial
    np.testing.assert_array_equal(parallel.decompress_plane(serial, cfg, mesh),
                                  decompress_band(serial, cfg))
    blob = compress_ycbcr(im, cfg)
    assert len(sharded.batch_shares(mesh, cfg, 1)) == 4
    assert parallel.compress_batch(im[None], cfg, mesh) == [blob]
    np.testing.assert_array_equal(parallel.decompress_batch([blob], mesh)[0],
                                  decompress_to_ycbcr(blob))


# ---------------------------------------------------------------------------
# The tables encoder (K9) and the two-sweep end table (K6')
# ---------------------------------------------------------------------------

def test_tables_encode_equals_lv_on_chip(img):
    cfg = _cfg()
    want = compress_ycbcr(img, cfg)
    got, counts = _launched(lambda: compress_ycbcr(img, cfg, enc="tables"))
    assert got == want
    assert counts["encode_stream_rows_tables"] == 1
    assert counts["encode_stream_rows"] == 0


def test_two_sweep_end_table_equals_single_on_chip():
    im = _synth(512, 512, seed=4)
    blob = compress_ycbcr(im, _cfg(height=512, width=512))
    _, data = container.read_data(blob)
    raw = b"".join((data.y, data.cb, data.cr))
    stream = DC.upload_stream(raw, DEV)
    single = DS.end_table(stream, len(raw), 64)
    two, counts = _launched(lambda: DS.end_table(stream, len(raw), 64,
                                                 cap=12))
    assert torch.equal(two, single)
    assert counts["scan_walk_capped"] == 1 and counts["scan_walk_resume"] == 1


# ---------------------------------------------------------------------------
# The band modules' buffer cache
# ---------------------------------------------------------------------------

def _host_to_device_bytes(fn, trace_dir):
    """``fn()`` under a profiler session and the byte counts of the
    host-to-device copies it made (the Chrome trace's ``gpu_memcpy``)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    path = os.path.join(trace_dir, f"trace{len(os.listdir(trace_dir))}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return out, [e["args"]["bytes"] for e in events
                 if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]]


def _two_profiled_decodes(blob_path, out_path):
    """The child's side of the case below: two ``decompress_to_ycbcr`` of
    one container in a fresh process, each under a profiler session; the
    byte counts of each call's host-to-device copies, whether the answers
    are equal and the first one's digest go to ``out_path`` as JSON."""
    with open(blob_path, "rb") as f:
        blob = f.read()
    trace_dir = os.path.dirname(out_path)
    (first, one), (second, two) = (
        _host_to_device_bytes(lambda: decompress_to_ycbcr(blob), trace_dir)
        for _ in range(2))
    with open(out_path, "w") as f:
        json.dump({"first": one, "second": two,
                   "equal": bool(np.array_equal(first, second)),
                   "digest": hashlib.sha256(first.tobytes()).hexdigest()}, f)


def test_band_cache_keeps_the_d24_operator_on_chip(tmp_path):
    """At d 24 (bs 4, a padded frame: K4 with the 576 x 576 decode
    operator, 1.3 MB in f32) the first ``decompress_to_ycbcr`` of a fresh
    process copies the operator to the card; the second copies nothing of
    1.3 MB or more and gives the same planes.  The profiler runs in a child
    process, so that the suite's process holds one session only, the
    tracing case's (in one suite run with these two sessions in its
    process, that case found no scan kernel in its trace).  Then, the cache cleared, a miss on
    one CUDA stream and a hit from a second right after it both give the
    serial planes, and no decode writes a cached tensor."""
    cfg = _cfg(height=200, width=300, dct_size=24, block_size=4,
               quantization=QuantizationMethod("divide", divisor=1000))
    blob = compress_ycbcr(_synth(200, 300, seed=17), cfg)
    serial = decompress_to_ycbcr(blob)
    op_bytes = 576 * 576 * 4
    blob_path, out_path = tmp_path / "blob.bin", tmp_path / "copies.json"
    blob_path.write_bytes(blob)
    subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, sys.argv[1]); "
         "import test_on_device as t; t._two_profiled_decodes(*sys.argv[2:])",
         os.path.dirname(os.path.abspath(__file__)), str(blob_path),
         str(out_path)], cwd=REPO, check=True, timeout=600)
    child = json.loads(out_path.read_text())
    assert max(child["first"]) >= op_bytes
    assert child["second"] and max(child["second"]) < op_bytes
    assert child["equal"]
    assert child["digest"] == hashlib.sha256(serial.tobytes()).hexdigest()

    band_ops._CACHE.clear()
    want = torch.from_numpy(serial).permute(2, 0, 1).to(DEV)
    one, two = torch.cuda.Stream(), torch.cuda.Stream()
    with torch.cuda.stream(one):
        missed = decompress_to_device(blob)
    with torch.cuda.stream(two):
        hit = decompress_to_device(blob)
    torch.cuda.synchronize()
    assert torch.equal(missed, want) and torch.equal(hit, want)
    held = {k: (e.tensor, e.tensor.clone())
            for k, e in band_ops._CACHE._entries.items()}
    assert any(t.numel() == 576 * 576 for t, _ in held.values())
    for _ in range(3):
        decompress_to_ycbcr(blob)
        decompress_to_device(blob, scan="device")
    torch.cuda.synchronize()
    for k, (t, copy) in held.items():
        assert band_ops._CACHE._entries[k].tensor is t
        assert torch.equal(t, copy)


# ---------------------------------------------------------------------------
# The plane pull into page-locked memory
# ---------------------------------------------------------------------------

def _profiled_pull(blob_path, out_path):
    """The child's side of the case below: a warm ``decompress_to_ycbcr``
    under a profiler session with spans recorded; the ``decode.pull`` and
    ``decode.check`` ranges and the device-to-host copies of its Chrome
    trace, whether the answer's block is pinned and its digest go to
    ``out_path`` as JSON."""
    from jpeg_tpu_torch.utils import profiling
    with open(blob_path, "rb") as f:
        blob = f.read()
    decompress_to_ycbcr(blob)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    profiling.start_recording()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            answer = decompress_to_ycbcr(blob)
    finally:
        profiling.stop_recording()
    path = os.path.join(os.path.dirname(out_path), "pull_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    with open(out_path, "w") as f:
        json.dump({
            "pulls": [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                      if e.get("cat") == "user_annotation"
                      and e["name"] == "decode.pull"],
            "checks": [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                       if e.get("cat") == "user_annotation"
                       and e["name"] == "decode.check"],
            "copies": [(e["name"], e["ts"], e["ts"] + e.get("dur", 0))
                       for e in events if e.get("cat") == "gpu_memcpy"
                       and "DtoH" in e["name"]],
            "pinned": bool(answer.base.base.is_pinned()),
            "digest": hashlib.sha256(answer.tobytes()).hexdigest()}, f)


def test_pinned_pull_on_chip(tmp_path, monkeypatch):
    """A d 24 ``decompress_to_ycbcr`` answer is a view of a page-locked
    block, bit-equal to ``decompress_to_device(...).cpu()`` with its
    strides; in a child process's profiler trace (one session there, as
    in the case above) the call's one device-to-host copy inside the span
    ``decode.pull`` lands in pinned memory, and at most one other, the
    device scan's one-byte check (``scan="auto"`` takes the device scan),
    lies inside ``decode.check``.  Answers held past a bound of two blocks
    take the pageable pull, raise nothing and give the same image, and the
    count of pinned bytes comes back when they die."""
    cfg = _cfg(height=200, width=300, dct_size=24, block_size=4,
               quantization=QuantizationMethod("divide", divisor=1000))
    blob = compress_ycbcr(_synth(200, 300, seed=19), cfg)
    want = decompress_to_device(blob).cpu().numpy().transpose(1, 2, 0)
    answer = decompress_to_ycbcr(blob)
    assert answer.base.base.is_pinned()
    assert answer.shape == want.shape and answer.strides == want.strides
    np.testing.assert_array_equal(answer, want)

    blob_path, out_path = tmp_path / "blob.bin", tmp_path / "pull.json"
    blob_path.write_bytes(blob)
    subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, sys.argv[1]); "
         "import test_on_device as t; t._profiled_pull(*sys.argv[2:])",
         os.path.dirname(os.path.abspath(__file__)), str(blob_path),
         str(out_path)], cwd=REPO, check=True, timeout=600)
    child = json.loads(out_path.read_text())
    assert child["pinned"]
    assert child["digest"] == hashlib.sha256(want.tobytes()).hexdigest()
    (p0, p1), = child["pulls"]
    in_pull = [c for c in child["copies"] if p0 <= c[1] <= c[2] <= p1]
    in_check = [c for c in child["copies"]
                if any(k0 <= c[1] <= c[2] <= k1 for k0, k1 in child["checks"])]
    (name, _, _), = in_pull
    assert "Pinned" in name, child
    assert len(in_check) <= 1, child
    assert len(in_pull) + len(in_check) == len(child["copies"]), child

    gc.collect()
    one = 1 << (answer.nbytes - 1).bit_length()
    base = api._PINNED.held
    monkeypatch.setattr(api, "_PINNED_ANSWER_BYTES", base + 2 * one)
    kept = [decompress_to_ycbcr(blob) for _ in range(4)]
    assert [a.base.base.is_pinned() for a in kept] == [True, True,
                                                       False, False]
    for a in kept:
        assert a.strides == want.strides
        np.testing.assert_array_equal(a, want)
    assert api._PINNED.held == base + 2 * one
    del kept, answer
    gc.collect()
    assert api._PINNED.held == base - one


# ---------------------------------------------------------------------------
# A decode's scan="auto": the device scan on a CUDA device
# ---------------------------------------------------------------------------

def _stream_bytes(blob):
    _, data = container.read_data(blob)
    return len(data.y) + len(data.cb) + len(data.cr)


def _corrupted(blob):
    """The first of a fixed list of changes to the luma stream's bytes that
    the host scanner rejects."""
    cfg, data = container.read_data(blob)
    L = cfg.dct_size ** 2
    head = len(blob) - _stream_bytes(blob)
    for off in range(0, len(data.y), 7):
        for mask in (0xFF, 0x0F, 0xF0):
            bad = bytearray(blob)
            bad[head + off] ^= mask
            _, d = container.read_data(bytes(bad))
            try:
                for s in (d.y, d.cb, d.cr):
                    DS._host_scan(s, cfg.num_blocks, L)
            except Exception:
                return bytes(bad)
    raise AssertionError("no change of the list is rejected")


def _error(fn):
    try:
        fn()
    except Exception as e:          # the host scan's error, whatever it is
        return type(e), str(e)
    raise AssertionError("no error")


def _profiled_auto_decode(blob_path, out_path):
    """The child's side of the case below: a warm ``decompress_to_ycbcr``
    with ``scan="auto"`` under a profiler session with spans recorded; the
    names of the kernels of its Chrome trace, the recorded spans and
    counters and the answer's digest go to ``out_path`` as JSON."""
    from jpeg_tpu_torch.utils import profiling
    with open(blob_path, "rb") as f:
        blob = f.read()
    decompress_to_ycbcr(blob)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    profiling.start_recording()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            answer = decompress_to_ycbcr(blob)
            torch.cuda.synchronize()
    finally:
        profiling.stop_recording()
    rec = profiling.recorded()
    path = os.path.join(os.path.dirname(out_path), "auto_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    with open(out_path, "w") as f:
        json.dump({
            "kernels": sorted({e["name"] for e in events
                               if e.get("cat") == "kernel"}),
            "spans": [s.name for s in rec.spans],
            "counts": rec.counts,
            "digest": hashlib.sha256(answer.tobytes()).hexdigest()}, f)


def test_auto_scan_takes_the_device_scan_at_4k_d24_on_chip(tmp_path):
    """A 3840x2160 d 24 container (bs 4, divide 1000: the benchmark's
    host->host configuration) through ``decompress_to_ycbcr()``: in a
    child process's profiler trace (one session there, as in the cases
    above) the call runs K6 (``scan_walk_kernel``) and K8
    (``chain_kernel``), records ``scan.device`` and no ``scan.host``, and
    counts ``scan.auto_device`` once; its image is bit-equal to
    ``scan="host"``'s; a corrupted copy and a truncated one raise the host
    scan's exception with its message."""
    cfg = _cfg(height=2160, width=3840, dct_size=24, block_size=4,
               quantization=QuantizationMethod("divide", divisor=1000))
    blob = compress_ycbcr(_synth(2160, 3840, seed=23), cfg)
    host = decompress_to_ycbcr(blob, scan="host")

    blob_path, out_path = tmp_path / "blob.bin", tmp_path / "auto.json"
    blob_path.write_bytes(blob)
    subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, sys.argv[1]); "
         "import test_on_device as t; t._profiled_auto_decode(*sys.argv[2:])",
         os.path.dirname(os.path.abspath(__file__)), str(blob_path),
         str(out_path)], cwd=REPO, check=True, timeout=600)
    child = json.loads(out_path.read_text())
    for k in ("scan_walk_kernel", "chain_kernel"):
        assert any(k in n for n in child["kernels"]), (k, child["kernels"])
    assert "scan.device" in child["spans"]
    assert "scan.host" not in child["spans"]
    assert child["counts"].get("scan.auto_device") == 1
    assert child["digest"] == hashlib.sha256(host.tobytes()).hexdigest()

    for bad in (_corrupted(blob), blob[:-3]):
        want = _error(lambda: decompress_to_ycbcr(bad, scan="host"))
        assert want[0] is not RuntimeError
        assert _error(lambda: decompress_to_ycbcr(bad)) == want


def test_auto_scan_takes_the_device_scan_at_one_block_on_chip():
    """An 8x8 d 24 container, one block a band (9 to 60 bytes of stream),
    takes the device scan too: one ``scan.device`` span, no ``scan.host``,
    one count; the image is the host scan's."""
    from jpeg_tpu_torch.utils import profiling
    cfg = _cfg(height=8, width=8, dct_size=24, block_size=2,
               quantization=QuantizationMethod("divide", divisor=1000))
    blob = compress_ycbcr(_synth(8, 8, seed=29), cfg)
    assert container.read_data(blob)[0].num_blocks == 1
    profiling.start_recording()
    try:
        got = decompress_to_ycbcr(blob)
    finally:
        profiling.stop_recording()
    rec = profiling.recorded()
    names = [s.name for s in rec.spans]
    assert names.count("scan.device") == 1 and "scan.host" not in names
    assert rec.counts.get("scan.auto_device") == 1
    np.testing.assert_array_equal(got, decompress_to_ycbcr(blob,
                                                           scan="host"))


@pytest.mark.parametrize("d,bs,transform", [
    (d, bs, t) for d in (8, 24) for bs in (2, 4) for t in ("DCT", "DFT")])
def test_auto_scan_equals_host_scan_on_chip(d, bs, transform):
    """``scan="auto"`` (the device scan, counted once a call) gives ``scan="host"``'s image bit for bit, through
    ``decompress_to_ycbcr``, ``decompress_many`` and ``Jpeg.decompress``."""
    from jpeg_tpu_torch import Jpeg
    from jpeg_tpu_torch.utils import profiling
    cfg = _cfg(height=200, width=300, dct_size=d, block_size=bs,
               transform=transform,
               quantization=QuantizationMethod("divide", divisor=20))
    blobs = [compress_ycbcr(_synth(200, 300, seed=31 + k), cfg)
             for k in range(2)]
    want = [decompress_to_ycbcr(b, scan="host") for b in blobs]
    profiling.start_recording()
    try:
        got = ([decompress_to_ycbcr(b) for b in blobs]
               + decompress_many(blobs)
               + [np.asarray(Jpeg.decompress(b)) for b in blobs])
    finally:
        profiling.stop_recording()
    assert profiling.recorded().counts.get("scan.auto_device") == 6
    for g, w in zip(got, want * 3):
        np.testing.assert_array_equal(g, w)
