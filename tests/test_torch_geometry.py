"""jpeg_tpu_torch's padded geometry, DFT, d=24 and truncating decode vs
jpeg_tpu's f32 path.

Tolerances:

* Operator builders, block ops (pad, subsample, inflate, blockify) and the
  (de)quantizers are bitwise equal to ``jpeg_tpu``'s: the same f64 numpy
  arithmetic, or the same f32 operations in the same order.
* Everything that ends in an f32 product and a round (K5's plain version,
  ``BandEncoder``, ``BandDecoder``, the API) equals ``jpeg_tpu`` and the
  f64 reference except +-1 where ``encode_reference_and_ties`` /
  ``decode_reference_and_ties`` (``jpeg_tpu/utils/parity.py``) mark a
  provable .5 tie: torch and XLA (or the interpret-mode Pallas kernels)
  sum in other orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jpeg_tpu
import jpeg_tpu.container as jcontainer
import jpeg_tpu.entropy as jentropy
from jpeg_tpu.config import Configuration as JConfiguration
from jpeg_tpu.config import QuantizationMethod as JQuantizationMethod
from jpeg_tpu.ops import band as jband
from jpeg_tpu.ops import blocks as JB
from jpeg_tpu.ops import pallas_kernels as PK
from jpeg_tpu.ops import quantize as JQ
from jpeg_tpu.ops import transform as JT
from jpeg_tpu.utils import parity as jparity

import jpeg_tpu_torch
from jpeg_tpu_torch.config import Configuration, QuantizationMethod
from jpeg_tpu_torch.ops import blocks as B
from jpeg_tpu_torch.ops import kernels as K
from jpeg_tpu_torch.ops import quantize as Q
from jpeg_tpu_torch.ops import transform as T
from jpeg_tpu_torch.ops.band import BandDecoder, BandEncoder

torch.set_num_threads(2)


def _cfgs(h, w, bs, d, transform, qname, qparams):
    t = Configuration(width=w, height=h, block_size=bs, dct_size=d,
                      transform=transform,
                      quantization=QuantizationMethod(qname, **qparams))
    j = JConfiguration(width=w, height=h, block_size=bs, dct_size=d,
                       transform=transform,
                       quantization=JQuantizationMethod(qname, **qparams))
    return t, j


def _band(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    b = (128 + 90 * np.sin(x / (7 + seed)) * np.cos(y / 9)
         + 12 * rng.standard_normal((h, w)))
    return np.clip(b, 0, 255).astype(np.uint8)


def _image(h, w, seed=7):
    return np.stack([_band(h, w, seed + c) for c in range(3)], axis=-1)


# ---------------------------------------------------------------------------
# Operators, block ops, quantizers: bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [3, 4, 8])
def test_new_operator_builders_bitwise_equal(d):
    for name in ("inverse_zigzag_permutation", "dft_encode_operator",
                 "dft_decode_operator", "dct_matrix_normalized",
                 "normalization_matrix"):
        np.testing.assert_array_equal(getattr(T, name)(d),
                                      getattr(JT, name)(d), err_msg=name)
    for bs in (1, 2, 3):
        for tr in ("DCT", "DFT"):
            np.testing.assert_array_equal(
                T.combined_encode_operator(d, bs, tr),
                JT.combined_encode_operator(d, bs, tr), err_msg=tr)
            np.testing.assert_array_equal(
                T.combined_decode_operator(d, bs, tr),
                JT.combined_decode_operator(d, bs, tr), err_msg=tr)


def test_d24_operators_bitwise_equal():
    for name in ("encode_operator", "decode_operator", "dft_encode_operator",
                 "dft_decode_operator", "inverse_zigzag_permutation"):
        np.testing.assert_array_equal(getattr(T, name)(24),
                                      getattr(JT, name)(24), err_msg=name)
    np.testing.assert_array_equal(T.separable_encode_factor(24, 1),
                                  JT.separable_encode_factor(24, 1))
    np.testing.assert_array_equal(T.combined_decode_operator(24, 2, "DFT"),
                                  JT.combined_decode_operator(24, 2, "DFT"))


BLOCK_CASES = [(23, 37, 4), (16, 32, 3), (30, 50, 5), (8, 16, 1),
               (24, 24, 2)]


@pytest.mark.parametrize("h,w,bs", BLOCK_CASES)
def test_block_ops_bitwise_equal(h, w, bs):
    a = _band(h, w, bs)
    a3 = np.stack([a, a[::-1], 255 - a])
    t, t3 = torch.from_numpy(a), torch.from_numpy(a3)
    ja = jnp.asarray(a)
    for f in (bs, 8):
        np.testing.assert_array_equal(
            B.pad_edge(t.to(torch.float32), f).numpy(),
            np.asarray(JB.pad_edge(ja, f)).astype(np.float32))
        np.testing.assert_array_equal(
            B.pad_edge_hw(t3.to(torch.float64), f).numpy(),
            np.asarray(JB.pad_edge_hw(jnp.asarray(a3), f)))
        # any dtype, uncast
        np.testing.assert_array_equal(
            B.pad_edge_hw(t3, f).numpy(),
            np.asarray(JB.pad_edge_hw(jnp.asarray(a3), f)))
    # f64: sum, then a true division (jit: behind JAX's barrier)
    want = np.asarray(jax.jit(JB.subsample, static_argnums=1)(
        ja.astype(jnp.float64), bs))
    np.testing.assert_array_equal(B.subsample(t.to(torch.float64), bs)
                                  .numpy(), want)
    # f32: the pinned order, batched and 2-D
    np.testing.assert_array_equal(B.subsample_fast(t, bs).numpy(),
                                  np.asarray(JB.subsample_fast(ja, bs)))
    np.testing.assert_array_equal(
        B.subsample_fast_hw(t3, bs).numpy(),
        np.asarray(JB.subsample_fast_hw(jnp.asarray(a3), bs)))
    np.testing.assert_array_equal(B.inflate(t, bs).numpy(),
                                  np.asarray(JB.inflate(ja, bs)))
    np.testing.assert_array_equal(
        B.blockify(t.to(torch.float32), 4).numpy(),
        np.asarray(JB.blockify(ja, 4)).astype(np.float32))


QUANTS = [("qtable", {}), ("none", {}), ("discard", {"keep": 3}),
          ("divide", {"divisor": 3})]


@pytest.mark.parametrize("qname,qparams", QUANTS + [("divide", {"divisor": 40})])
def test_quantize_f64_epilogue_is_jax_parity_quantize(qname, qparams):
    """The port's f64 quantize is the epilogue ``round(c * mul / div) *
    mask`` with unit factors; JAX's parity quantize is ``round(c / div)``
    and ``round(c * (1/q))`` behind its barrier.  Bitwise equal, exact
    halves and divide-by-3 ties included."""
    tm = QuantizationMethod(qname, **qparams)
    jm = JQuantizationMethod(qname, **qparams)
    rng = np.random.default_rng(5)
    c = np.round(rng.standard_normal((40, 64)) * 800, 1)
    c[0] = np.arange(64) - 31.5                         # exact halves
    c[1] = (np.arange(64) + 0.5) * 3                    # halves after / 3
    c[2] = c[1] * 1.0000000000000002
    got = Q.quantize(torch.from_numpy(c), tm, 8).numpy()
    want = np.asarray(jax.jit(lambda x: JQ.quantize(x, jm, 8))(
        jnp.asarray(c)))
    np.testing.assert_array_equal(got, want)


DEQ_METHODS = [("none", {}), ("discard", {"keep": 2}), ("qtable", {}),
               ("divide", {"divisor": 40}), ("divide", {"divisor": 2.5}),
               ("divide", {"divisor": 2.3}), ("divide", {"divisor": 200000})]


@pytest.mark.parametrize("qname,qparams", DEQ_METHODS)
def test_dequantize_matches_jax_in_both_modes(qname, qparams):
    """Parity mode: int64 / f64 as ``jpeg_tpu`` with x64.  f32 mode: the
    same values and integer/float kind as ``jpeg_tpu`` with x64 off (the
    truncating f32 product, and the f32 product where int32 would wrap)."""
    tm = QuantizationMethod(qname, **qparams)
    jm = JQuantizationMethod(qname, **qparams)
    rng = np.random.default_rng(9)
    lv = rng.integers(-300, 301, (6, 64))
    lv[0, :4] = [16383, -16383, 1, -1]
    got = Q.dequantize(torch.from_numpy(lv), tm, 8, parity=True)
    want = np.asarray(JQ.dequantize(jnp.asarray(lv), jm, 8))
    assert got.dtype == torch.int64 and want.dtype == np.int64
    np.testing.assert_array_equal(got.numpy(), want)
    lv32 = lv.astype(np.int32)
    got = Q.dequantize(torch.from_numpy(lv32), tm, 8)
    with jax.enable_x64(False):
        want = np.asarray(JQ.dequantize(jnp.asarray(lv32), jm, 8))
    assert got.dtype.is_floating_point == np.issubdtype(want.dtype,
                                                        np.floating)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# K5: the plain version vs the interpret-mode Pallas kernel
# ---------------------------------------------------------------------------

def _k5_inputs(h, w, d, transform, qname, qparams):
    tcfg, jcfg = _cfgs(h, w, 1, d, transform, qname, qparams)
    band = _band(h, w, d)
    vec = B.blockify(torch.from_numpy(band).to(torch.float32), d) \
        .reshape(-1, d * d).contiguous()
    op = (T.encode_operator(d) if transform == "DCT"
          else T.dft_encode_operator(d))
    vecs = [torch.from_numpy(v.astype(np.float32))
            for v in Q.epilogue_vectors(tcfg.quantization, d)]
    return jcfg, band, vec, op, vecs


@pytest.mark.parametrize("transform", ["DCT", "DFT"])
@pytest.mark.parametrize("qname,qparams", QUANTS)
def test_encode_blocks_plain_matches_pallas_interpret(transform, qname,
                                                      qparams):
    jcfg, band, vec, op, vecs = _k5_inputs(24, 40, 8, transform, qname,
                                           qparams)
    op_t = torch.from_numpy(op.T.astype(np.float32)).contiguous()
    got = K.encode_blocks(vec, op_t, *vecs)
    assert got.dtype == torch.int32 and got.shape == (15, 64)
    want = np.asarray(PK.encode_blocks(
        jnp.asarray(vec.numpy()), jnp.asarray(op_t.numpy()),
        *(jnp.asarray(v.numpy()) for v in vecs), interpret=True))
    ref, ties = jparity.encode_reference_and_ties(jcfg, band)
    jparity.assert_tie_equal(got.numpy(), want, ties, "vs Pallas")
    jparity.assert_tie_equal(got.numpy(), ref, ties, "vs f64")


def test_encode_blocks_plain_at_d24():
    jcfg, band, vec, op, vecs = _k5_inputs(24, 48, 24, "DFT", "divide",
                                           {"divisor": 1000})
    op_t = torch.from_numpy(op.T.astype(np.float32)).contiguous()
    got = K.encode_blocks(vec, op_t, *vecs)
    want = np.asarray(PK.encode_blocks(
        jnp.asarray(vec.numpy()), jnp.asarray(op_t.numpy()),
        *(jnp.asarray(v.numpy()) for v in vecs), interpret=True))
    ref, ties = jparity.encode_reference_and_ties(jcfg, band)
    assert got.shape == (2, 576)
    jparity.assert_tie_equal(got.numpy(), want, ties, "vs Pallas")
    jparity.assert_tie_equal(got.numpy(), ref, ties, "vs f64")


def test_encode_blocks_divides_then_rounds_half_to_even():
    """The epilogue is an IEEE multiply, then a true division, then round
    half to even: 7.5 / 3 is 2.5 and rounds to 2 (times the reciprocal of
    3 it would be 2.5000002 and round to 3); a zero mask zeroes."""
    x = torch.tensor([[7.5], [1.5], [2.5], [-2.5], [300.0]])
    op_t = torch.ones((1, 1))
    one = torch.ones(1)
    assert K.encode_blocks(x, op_t, one, one * 3, one).flatten().tolist() \
        == [2, 0, 1, -1, 100]
    assert K.encode_blocks(x, op_t, one, one, one).flatten().tolist() \
        == [8, 2, 2, -2, 300]
    assert not K.encode_blocks(x, op_t, one, one, one * 0).any()


def test_encode_blocks_checks_inputs_and_never_falls_back():
    x = torch.zeros((4, 64))
    op_t = torch.zeros((64, 64))
    v = torch.ones(64)
    before = K.launch_counts()
    assert K.encode_blocks(x, op_t, v, v, v).shape == (4, 64)
    assert K.launch_counts() == before      # the plain version launches nothing
    with pytest.raises(ValueError, match="float32"):
        K.encode_blocks(x.double(), op_t, v, v, v)
    with pytest.raises(ValueError, match="op_t"):
        K.encode_blocks(x, torch.zeros((32, 64)), v, v, v)
    with pytest.raises(ValueError, match="vectors"):
        K.encode_blocks(x, op_t, v, torch.ones(32), v)
    with pytest.raises(ValueError, match="contiguous"):
        K.encode_blocks(torch.zeros((64, 4)).t(), op_t, v, v, v)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        K.encode_blocks(x.to("meta"), op_t.to("meta"), v.to("meta"),
                        v.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="different devices"):
        K.encode_blocks(x, op_t, v, v, v.to("meta"))


# ---------------------------------------------------------------------------
# BandEncoder / BandDecoder vs make_encode / make_decode, f32
# ---------------------------------------------------------------------------

# The six golden configurations, then bs 5, the wrap guard and the DFT on
# divisible geometry.
GEOMETRIES = {
    "cli_defaults_bs4": (23, 37, 4, 8, "DCT", "qtable", {}),
    "default_qtable": (32, 48, 2, 8, "DCT", "qtable", {}),
    "dft_none": (16, 32, 3, 8, "DFT", "none", {}),
    "discard_d4": (8, 16, 1, 4, "DCT", "discard", {"keep": 2}),
    "divide1000_d24": (30, 50, 5, 24, "DCT", "divide", {"divisor": 1000}),
    "rounding_none": (24, 24, 2, 8, "DCT", "none", {}),
    "bs5_qtable": (46, 61, 5, 8, "DCT", "qtable", {}),
    "divide200000": (32, 48, 2, 8, "DCT", "divide", {"divisor": 200000}),
    "dft_divisible_qtable": (32, 48, 2, 8, "DFT", "qtable", {}),
}
ENCODE_BRANCH = {"cli_defaults_bs4": "sep_pad", "default_qtable": "separable",
                 "dft_none": "blocks", "discard_d4": "separable",
                 "divide1000_d24": "sep_pad", "rounding_none": "sep_pad",
                 "bs5_qtable": "sep_pad", "divide200000": "separable",
                 "dft_divisible_qtable": "combined"}


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_band_encoder_matches_make_encode(name, use_pallas):
    h, w, bs, d, tr, qn, qp = GEOMETRIES[name]
    tcfg, jcfg = _cfgs(h, w, bs, d, tr, qn, qp)
    bands = np.stack([_band(h, w, s) for s in range(3)])
    enc = BandEncoder(tcfg)
    assert enc.branch == ENCODE_BRANCH[name]
    got = enc(torch.from_numpy(bands))
    assert got.dtype == torch.int32
    assert got.shape == (3, tcfg.num_blocks, d * d)
    f = jband.make_encode(jband.config_key(jcfg), "float32", use_pallas)
    for b in range(3):
        want = np.asarray(f(jnp.asarray(bands[b])))
        ref, ties = jparity.encode_reference_and_ties(jcfg, bands[b])
        jparity.assert_tie_equal(got[b].numpy(), want, ties, f"band {b}")
        jparity.assert_tie_equal(got[b].numpy(), ref, ties, f"f64 band {b}")


DECODE_BRANCH = {"divide200000": "combined"}


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_band_decoder_matches_make_decode(name, use_pallas):
    h, w, bs, d, tr, qn, qp = GEOMETRIES[name]
    tcfg, jcfg = _cfgs(h, w, bs, d, tr, qn, qp)
    L = d * d
    rng = np.random.default_rng(h * w)
    lv = np.where(rng.random((3, tcfg.num_blocks, L)) < 0.3,
                  rng.integers(-30, 31, (3, tcfg.num_blocks, L)), 0)
    lv[:, :, 0] = rng.integers(-60, 61, (3, tcfg.num_blocks))
    if qn == "divide" and qp["divisor"] > 1000:
        lv[:, :, 0] = rng.choice([16383, -16383, 11000, 0], (3,
                                                             tcfg.num_blocks))
    lv = lv.astype(np.int32)
    dec = BandDecoder(tcfg)
    assert dec.branch == DECODE_BRANCH.get(name, "kernel")
    got = dec(torch.from_numpy(lv))
    assert got.dtype == torch.uint8 and got.shape == (3, h, w)
    f = jband.make_decode(jband.config_key(jcfg), "float32", use_pallas)
    for b in range(3):
        want = np.asarray(f(jnp.asarray(lv[b])))
        ref, ties = jparity.decode_reference_and_ties(jcfg, lv[b])
        jparity.assert_tie_equal(got[b].numpy(), want, ties, f"band {b}")
        jparity.assert_tie_equal(got[b].numpy(), ref, ties, f"f64 band {b}")


@pytest.mark.parametrize("h,w", [(32, 48), (23, 37)])
def test_truncating_decode_matches_make_decode_in_f32_mode(h, w):
    """Divisor 2.3: the f32 mode truncates ``f32(level) * f32(2.3)``, as the
    JAX package does with x64 off; padded geometry takes the chain, divisible
    the combined product.  Equal except +-1 at ties."""
    tcfg, jcfg = _cfgs(h, w, 2, 8, "DCT", "divide", {"divisor": 2.3})
    rng = np.random.default_rng(4)
    lv = np.where(rng.random((tcfg.num_blocks, 64)) < 0.3,
                  rng.integers(-40, 41, (tcfg.num_blocks, 64)), 0)
    lv = lv.astype(np.int32)
    got = BandDecoder(tcfg)(torch.from_numpy(lv)[None])[0].numpy()
    with jax.enable_x64(False):
        want = np.asarray(jband.make_decode(jband.config_key(jcfg),
                                            "float32", False)(
            jnp.asarray(lv)))
    _, ties = jparity.decode_reference_and_ties(jcfg, lv)
    jparity.assert_tie_equal(got, want, ties, "divide 2.3")


# ---------------------------------------------------------------------------
# The API at BASELINE configurations 2-4, small sizes, vs jpeg_tpu's f32 API
# ---------------------------------------------------------------------------

BASELINE = {
    "2_bs5_qtable": (46, 61, 5, 8, "DCT", "qtable", {}),
    "3_d24_divide1000": (60, 90, 2, 24, "DCT", "divide", {"divisor": 1000}),
    "4_dft_divisible": (32, 48, 2, 8, "DFT", "qtable", {}),
    "4_dft_ragged": (35, 52, 3, 8, "DFT", "none", {}),
}


@pytest.mark.parametrize("name", sorted(BASELINE))
def test_api_baseline_configs_match_jax_f32(name):
    h, w, bs, d, tr, qn, qp = BASELINE[name]
    tcfg, jcfg = _cfgs(h, w, bs, d, tr, qn, qp)
    img = _image(h, w)
    blob = jpeg_tpu_torch.compress_ycbcr(img, tcfg, device="cpu")
    jblob = jpeg_tpu.compress_ycbcr(img, jcfg, dtype=np.float32)
    n, L = jcfg.num_blocks, d * d
    _, data = jcontainer.read_data(blob)
    _, jdata = jcontainer.read_data(jblob)
    streams = (data.y, data.cb, data.cr)
    for b, (s, js) in enumerate(zip(streams, (jdata.y, jdata.cb, jdata.cr))):
        _, ties = jparity.encode_reference_and_ties(jcfg, img[:, :, b])
        jparity.assert_tie_equal(jentropy.decode_levels(s, n, L),
                                 jentropy.decode_levels(js, n, L), ties,
                                 f"levels band {b}")
    rec = jpeg_tpu_torch.decompress_to_ycbcr(blob, device="cpu")
    want = jpeg_tpu.decompress_to_ycbcr(blob, dtype=np.float32)
    for b, s in enumerate(streams):
        _, ties = jparity.decode_reference_and_ties(
            jcfg, jentropy.decode_levels(s, n, L))
        jparity.assert_tie_equal(rec[:, :, b], want[:, :, b], ties,
                                 f"planes band {b}")
    np.testing.assert_array_equal(
        jpeg_tpu_torch.decompress_to_ycbcr(blob, device="cpu",
                                           scan="device"), rec)
