"""jpeg_tpu_torch operators and band modules vs jpeg_tpu.

* Operator builders and quantizer vectors (the codec's "weights") are
  built in f64 numpy by both packages and must be bitwise equal.
* ``BandEncoder`` vs ``jpeg_tpu.ops.band.make_encode(key, "float32",
  False)`` and ``BandDecoder`` vs ``make_decode(key, "float32", False)``:
  equal except +-1 where ``encode_reference_and_ties`` /
  ``decode_reference_and_ties`` (``jpeg_tpu/utils/parity.py``) mark a
  provable .5 tie, the f32 summation orders of torch and XLA differing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_tpu.config import Configuration as JConfiguration
from jpeg_tpu.config import QuantizationMethod as JQuantizationMethod
from jpeg_tpu.ops import band as jband
from jpeg_tpu.ops import quantize as JQ
from jpeg_tpu.ops import transform as JT
from jpeg_tpu.utils import parity as jparity

from jpeg_tpu_torch.config import Configuration, QuantizationMethod
from jpeg_tpu_torch.ops import quantize as Q
from jpeg_tpu_torch.ops import transform as T
from jpeg_tpu_torch.ops.band import BandDecoder, BandEncoder
from jpeg_tpu_torch.utils import parity as tparity

torch.set_num_threads(2)

QUANTS = [("qtable", {}), ("none", {}), ("discard", {"keep": 3}),
          ("divide", {"divisor": 40})]


def _cfgs(h, w, bs, d, qname, qparams):
    t = Configuration(width=w, height=h, block_size=bs, dct_size=d,
                      quantization=QuantizationMethod(qname, **qparams))
    j = JConfiguration(width=w, height=h, block_size=bs, dct_size=d,
                       quantization=JQuantizationMethod(qname, **qparams))
    return t, j


def _band(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    b = (128 + 90 * np.sin(x / (7 + seed)) * np.cos(y / 9)
         + 12 * rng.standard_normal((h, w)))
    return np.clip(b, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("d", [4, 8, 16])
def test_operators_bitwise_equal(d):
    for name in ("dct_matrix", "idct_matrix", "zigzag_permutation",
                 "encode_operator", "decode_operator"):
        np.testing.assert_array_equal(getattr(T, name)(d),
                                      getattr(JT, name)(d), err_msg=name)
    for bs in (1, 2, 3, 5):
        np.testing.assert_array_equal(T.separable_encode_factor(d, bs),
                                      JT.separable_encode_factor(d, bs))
        np.testing.assert_array_equal(T.combined_decode_operator(d, bs),
                                      JT.combined_decode_operator(d, bs))


@pytest.mark.parametrize("qname,qparams", QUANTS)
def test_quantizer_vectors_bitwise_equal(qname, qparams):
    d = 8
    tm = QuantizationMethod(qname, **qparams)
    jm = JQuantizationMethod(qname, **qparams)
    for a, b in zip(Q.epilogue_vectors(tm, d), JQ.epilogue_vectors(jm, d)):
        np.testing.assert_array_equal(a, b)
    ti, ji = Q.dequant_int_vector(tm, d), JQ.dequant_int_vector(jm, d)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(Q.qtable_zigzag(8), JQ.qtable_zigzag(8))
    # the elementwise quantizer itself, in f32
    rng = np.random.default_rng(1)
    c = (rng.standard_normal((50, 64)) * 400).astype(np.float32)
    c[0, :8] = [0.5, 1.5, -0.5, -2.5, 40.0, 20.0, 60.0, -20.0]
    got = Q.quantize(torch.from_numpy(c), tm, d).numpy()
    want = np.asarray(JQ.quantize(jnp.asarray(c), jm, d))
    np.testing.assert_array_equal(got, want)


def test_divide_float_divisor_has_no_int_vector():
    """A non-integer divisor restores by truncation, so it has no integer
    dequantizer for K4: BandDecoder takes the plain truncating branch, equal
    to ``make_decode(key, "float32", False)`` (2.5 makes every product
    exact in f32 and f64, so the two are bitwise equal)."""
    m = QuantizationMethod("divide", divisor=2.5)
    assert Q.dequant_int_vector(m, 8) is None
    for h, w in ((32, 48), (23, 37)):
        tcfg, jcfg = _cfgs(h, w, 2, 8, "divide", {"divisor": 2.5})
        rng = np.random.default_rng(h)
        lv = np.where(rng.random((tcfg.num_blocks, 64)) < 0.3,
                      rng.integers(-40, 41, (tcfg.num_blocks, 64)), 0)
        lv = lv.astype(np.int32)
        dec = BandDecoder(tcfg)
        assert dec.branch == ("combined" if h == 32 else "chain")
        got = dec(torch.from_numpy(lv)[None])[0].numpy()
        want = np.asarray(jband.make_decode(jband.config_key(jcfg), "float32",
                                            False)(jnp.asarray(lv)))
        np.testing.assert_array_equal(got, want)


ENC_CASES = [  # (h, w, bs, d, quantizer index)
    (64, 96, 2, 8, 0), (32, 48, 1, 8, 1), (48, 64, 2, 8, 2),
    (64, 64, 2, 8, 3), (48, 72, 3, 4, 1)]


@pytest.mark.parametrize("h,w,bs,d,qi", ENC_CASES)
def test_band_encoder_matches_jax_f32_except_ties(h, w, bs, d, qi):
    tcfg, jcfg = _cfgs(h, w, bs, d, *QUANTS[qi])
    bands = np.stack([_band(h, w, s) for s in range(3)])
    got = BandEncoder(tcfg)(torch.from_numpy(bands))
    assert got.dtype == torch.int32 and got.shape == (3, tcfg.num_blocks,
                                                      d * d)
    enc = jax.jit(jband.make_encode(jband.config_key(jcfg), "float32", False))
    for b in range(3):
        want = np.asarray(enc(jnp.asarray(bands[b])))
        ref, ties = jparity.encode_reference_and_ties(jcfg, bands[b])
        jparity.assert_tie_equal(got[b].numpy(), want, ties, f"band {b}")
        jparity.assert_tie_equal(got[b].numpy(), ref, ties, f"f64 band {b}")


DEC_CASES = [  # (h, w, bs, d, quantizer index): divisible and padded
    (64, 96, 2, 8, 0), (32, 48, 1, 8, 1), (23, 37, 4, 8, 0),
    (30, 50, 5, 8, 3), (40, 56, 2, 4, 2)]


@pytest.mark.parametrize("h,w,bs,d,qi", DEC_CASES)
def test_band_decoder_matches_jax_f32_except_ties(h, w, bs, d, qi):
    tcfg, jcfg = _cfgs(h, w, bs, d, *QUANTS[qi])
    L = d * d
    rng = np.random.default_rng(h * w + qi)
    lv = np.where(rng.random((3, tcfg.num_blocks, L)) < 0.3,
                  rng.integers(-40, 41, (3, tcfg.num_blocks, L)), 0)
    lv[:, :, 0] = rng.integers(-60, 61, (3, tcfg.num_blocks))
    lv = lv.astype(np.int32)
    got = BandDecoder(tcfg)(torch.from_numpy(lv))
    assert got.dtype == torch.uint8 and got.shape == (3, h, w)
    dec = jax.jit(jband.make_decode(jband.config_key(jcfg), "float32", False))
    for b in range(3):
        want = np.asarray(dec(jnp.asarray(lv[b])))
        ref, ties = jparity.decode_reference_and_ties(jcfg, lv[b])
        jparity.assert_tie_equal(got[b].numpy(), want, ties, f"band {b}")
        jparity.assert_tie_equal(got[b].numpy(), ref, ties, f"f64 band {b}")


def test_port_parity_module_equals_jax_package():
    """The port's copy of the tie contract (used on the GPU, where jpeg_tpu
    cannot be imported) gives the same references and masks."""
    tcfg, jcfg = _cfgs(48, 64, 2, 8, "qtable", {})
    band = _band(48, 64, 5)
    for a, b in zip(tparity.encode_reference_and_ties(tcfg, band),
                    jparity.encode_reference_and_ties(jcfg, band)):
        np.testing.assert_array_equal(a, b)
    lv = jparity.encode_reference_and_ties(jcfg, band)[0]
    for a, b in zip(tparity.decode_reference_and_ties(tcfg, lv),
                    jparity.decode_reference_and_ties(jcfg, lv)):
        np.testing.assert_array_equal(a, b)


def test_modules_hold_operators_as_buffers():
    tcfg, _ = _cfgs(32, 48, 2, 8, "qtable", {})
    enc, dec = BandEncoder(tcfg), BandDecoder(tcfg)
    assert set(dict(enc.named_buffers())) == {"fac_t", "zigzag", "mul", "div",
                                              "mask"}
    assert set(dict(dec.named_buffers())) == {"op_t", "deq"}
    assert dec.op_t.dtype == torch.float32 and dec.deq.dtype == torch.int32
    np.testing.assert_array_equal(
        enc.mul.numpy(), (1.0 / Q.qtable_zigzag(8)).astype(np.float32))
    assert not list(enc.parameters()) and not list(dec.parameters())


def test_unported_branches_raise():
    """The branches the port now has beside the divisible DCT encode:
    padded DCT (``sep_pad``), divisible DFT (``combined``) and padded DFT
    (``blocks``, kernel K5) encode within the tie contract of ``jpeg_tpu``'s
    f32 ``make_encode`` and of the f64 reference."""
    for h, w, bs, transform, branch in ((23, 37, 4, "DCT", "sep_pad"),
                                        (32, 48, 2, "DFT", "combined"),
                                        (23, 37, 3, "DFT", "blocks")):
        tcfg = Configuration(width=w, height=h, block_size=bs,
                             transform=transform,
                             quantization=QuantizationMethod("qtable"))
        jcfg = JConfiguration(width=w, height=h, block_size=bs,
                              transform=transform,
                              quantization=JQuantizationMethod("qtable"))
        band = _band(h, w, bs)
        enc = BandEncoder(tcfg)
        assert enc.branch == branch
        got = enc(torch.from_numpy(band)[None])[0].numpy()
        want = np.asarray(jband.make_encode(jband.config_key(jcfg), "float32",
                                            False)(jnp.asarray(band)))
        ref, ties = jparity.encode_reference_and_ties(jcfg, band)
        jparity.assert_tie_equal(got, want, ties, branch)
        jparity.assert_tie_equal(got, ref, ties, f"f64 {branch}")
