"""jpeg_tpu_torch's step pipeline and class-level API vs jpeg_tpu.

Mirrors ``tests/test_steps.py``, ``tests/test_classic_api.py`` and
``tests/test_bitio.py``, holding the port against ``jpeg_tpu`` (the
reference itself is not installed here).  ``tests/conftest.py`` turns x64
on for the session, so ``jpeg_tpu.steps`` runs in its parity mode.
Tolerances:

* The port's ``dtype=torch.float64`` steps equal ``jpeg_tpu.steps``
  intermediate by intermediate, both directions, values and dtypes.
* The port's f32 steps: integer steps and permutations exact; f32 planes
  within one f32 rounding (rtol 2**-23); transform coefficients within the
  f32 accumulation bound ``(d*d + 16) * eps32 * sum|terms|``
  (``utils/parity.py``); rounded outputs (quantized levels, the inverse
  transform's integers) equal except +-1 where the exact value sits within
  that bound of a .5 tie.
* Host classes (bit IO, tuples, quantizer objects, array utilities) exact.
"""
import warnings

import numpy as np
import pytest
import torch

import jpeg_tpu
from jpeg_tpu import steps as jsteps
from jpeg_tpu.entropy import bitio as jbitio
from jpeg_tpu.entropy import tuples as jtuples
from jpeg_tpu.ops import quantize as jquantize
from jpeg_tpu.utils import arrays as jarrays

import jpeg_tpu_torch
from jpeg_tpu_torch import Configuration, QuantizationMethod, steps
from jpeg_tpu_torch.config import (BadArrayShapeError, BadRleCodeError,
                                   BadStreamError, EmptyArrayError)
from jpeg_tpu_torch.entropy import numpy_codec as NC
from jpeg_tpu_torch.entropy import tuples as TU
from jpeg_tpu_torch.entropy.bitio import (BitDecoder, BitEncoder, Bits,
                                          RunLengthBlock, RunLengthCode)
from jpeg_tpu_torch.ops import quantize as Q
from jpeg_tpu_torch.ops import transform as T
from jpeg_tpu_torch.utils import arrays as UA

torch.set_num_threads(2)

EPS32 = 2.0 ** -23

CONFIGS = [
    (16, 8, 2, 8, "DCT", None),
    (37, 23, 5, 8, "DCT", ("qtable", {})),
    (20, 10, 3, 4, "DCT", ("divide", {"divisor": 40})),
    (16, 8, 2, 4, "DCT", ("discard", {"keep": 2})),
    (16, 8, 3, 8, "DFT", None),
    (24, 16, 2, 8, "DFT", ("divide", {"divisor": 40})),
]
NAMES = ["Padding", "SubSampling", "DCTPadding", "Normalization",
         "BasisChange", "Quantization", "ZigzagOrder", "RunLengthEncoding",
         "RleBytestream"]


def _pair(w, h, bs, d, tr, q):
    qt = QuantizationMethod(q[0], **q[1]) if q else None
    qj = jpeg_tpu.QuantizationMethod(q[0], **q[1]) if q else None
    return (Configuration(width=w, height=h, block_size=bs, dct_size=d,
                          transform=tr, quantization=qt),
            jpeg_tpu.Configuration(width=w, height=h, block_size=bs,
                                   dct_size=d, transform=tr,
                                   quantization=qj))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return a if isinstance(a, (bytes, list)) else np.asarray(a)


def _assert_same(ours, theirs, stage):
    ours, theirs = _np(ours), _np(theirs)
    if isinstance(theirs, (bytes, list)):
        assert ours == theirs, stage
        return
    assert ours.shape == theirs.shape, f"{stage}: {ours.shape} {theirs.shape}"
    assert ours.dtype == theirs.dtype, f"{stage}: {ours.dtype} {theirs.dtype}"
    np.testing.assert_array_equal(ours, theirs, err_msg=stage)


def _plane(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, (h, w)).astype(
        np.int64)


def test_registry_order_matches_jpeg_tpu():
    assert [c.__name__ for c in steps.step_classes] == NAMES
    assert [c.__name__ for c in jsteps.step_classes] == NAMES
    assert [c.step_index for c in steps.step_classes] == list(range(9))


@pytest.mark.parametrize("w,h,bs,d,tr,q", CONFIGS)
def test_f64_steps_equal_jpeg_tpu_steps(w, h, bs, d, tr, q):
    """Every intermediate of the nine steps, both directions, bit for bit
    and dtype for dtype (jpeg_tpu in x64: its parity mode)."""
    cfg, jcfg = _pair(w, h, bs, d, tr, q)
    ours = [cls(cfg, "cpu", torch.float64) for cls in steps.step_classes]
    theirs = [cls(jcfg) for cls in jsteps.step_classes]
    a = b = _plane(12345, h, w)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for o, t in zip(ours, theirs):
            a, b = o.execute(a), t.execute(b)
            _assert_same(a, b, f"execute[{o.step_index}]")
        for o, t in zip(reversed(ours), reversed(theirs)):
            a, b = o.invert(a), t.invert(b)
            _assert_same(a, b, f"invert[{o.step_index}]")


def _quant_factors(jcfg, shape):
    """(mul plane, divisor, mask plane) of the quantizer, f64."""
    m, d = jcfg.quantization, jcfg.dct_size
    tile = (shape[0] // d, shape[1] // d)
    mul, mask, div = np.ones(shape), np.ones(shape), 1.0
    if m.name == "qtable":
        mul = np.tile(1.0 / jquantize.JPEG_QTABLE, tile)
    elif m.name == "divide":
        div = float(m.divisor)
    elif m.name == "discard":
        keep = np.arange(d) < m.keep
        mask = np.tile((keep[:, None] & keep[None, :]).astype(float), tile)
    return mul, div, mask


def _blocks(a, d):
    h, w = a.shape
    return a.reshape(h // d, d, w // d, d).transpose(0, 2, 1, 3).reshape(
        -1, d * d)


def _unblocks(v, h, w, d):
    return v.reshape(h // d, w // d, d, d).transpose(0, 2, 1, 3).reshape(h, w)


def _operator(d, tr, inverse):
    """Row-major (d*d, d*d) operator and the magnitudes that bound its f32
    error: the DCT's kron operators, the DFT's F kron F (|entries| = 1) or
    its inverse (|entries| = 1 / (d*d))."""
    if tr == "DCT":
        op = T.kron_inverse_operator(d) if inverse else T.kron_operator(d)
        return op, np.abs(op)
    j = np.arange(d)
    f = np.exp((2j if inverse else -2j) * np.pi * np.outer(j, j) / d)
    op = np.kron(f, f) / (d * d if inverse else 1)
    return op, np.abs(op)


def _ties(exact, bound):
    return np.abs(exact - np.floor(exact) - 0.5) <= bound


def _assert_tie_equal(got, want, ties, stage):
    diff = got != want
    assert not (diff & ~ties).any(), f"{stage}: non-tie mismatch"
    assert (np.abs(got.astype(np.int64) - want.astype(np.int64))[diff]
            <= 1).all(), f"{stage}: tie off by more than 1"


@pytest.mark.parametrize("w,h,bs,d,tr,q", CONFIGS)
def test_f32_steps_within_the_tie_contract(w, h, bs, d, tr, q):
    """The f32 steps (dtype=None) against jpeg_tpu's x64 steps: exact where
    the step is integer or a copy, within f32 rounding where it is a plane
    of means, within the accumulation bound for the transform, and +-1 at
    provable ties where a value is rounded.  Integer steps after a rounded
    one get jpeg_tpu's step on the port's own input."""
    cfg, jcfg = _pair(w, h, bs, d, tr, q)
    ours = [cls(cfg, "cpu") for cls in steps.step_classes]
    theirs = [cls(jcfg) for cls in jsteps.step_classes]
    a = _plane(777, h, w)
    L = d * d
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        p0, j0 = ours[0].execute(a), theirs[0].execute(a)
        _assert_same(p0, j0, "execute[0]")
        p1, j1 = ours[1].execute(p0), theirs[1].execute(j0)
        assert p1.dtype == torch.float32
        np.testing.assert_allclose(_np(p1), _np(j1), rtol=2 * EPS32, atol=0)
        p2, j2 = ours[2].execute(p1), theirs[2].execute(j1)
        np.testing.assert_allclose(_np(p2), _np(j2), rtol=2 * EPS32, atol=0)
        p3, j3 = ours[3].execute(p2), theirs[3].execute(j2)
        p4, j4 = ours[4].execute(p3), theirs[4].execute(j3)
        # transform: |f32 - exact| <= (L + 16) eps32 sum|x||op|
        x = _blocks(_np(j3), d)
        _, mag = _operator(d, tr, inverse=False)
        H, W = _np(j3).shape
        bound4 = _unblocks((L + 16) * EPS32 * (np.abs(x) @ mag.T), H, W, d)
        e4, g4 = _np(j4), _np(p4)
        for part in (np.real, np.imag):
            assert (np.abs(part(g4) - part(e4)) <= bound4).all(), "execute[4]"
        # quantize: +-1 where the exact quotient is within reach of a tie
        p5, j5 = ours[5].execute(p4), theirs[5].execute(j4)
        mul, div, mask = _quant_factors(jcfg, e4.shape)
        for part in (np.real, np.imag):
            ex = part(e4) * mul / div
            tie = _ties(ex, bound4 * mul / div + 4 * EPS32 * np.abs(ex)) \
                & (mask != 0)
            _assert_tie_equal(part(_np(p5)), part(_np(j5)), tie, "execute[5]")
        prev = p5
        for o, t in zip(ours[6:], theirs[6:]):
            got = o.execute(prev)
            _assert_same(got, t.execute(_np(prev)), f"execute[{o.step_index}]")
            prev = got
        for o, t in zip(reversed(ours[5:]), reversed(theirs[5:])):
            got = o.invert(prev)
            _assert_same(got, t.invert(_np(prev) if isinstance(
                prev, torch.Tensor) else prev), f"invert[{o.step_index}]")
            prev = got
        # inverse transform: +-1 at ties of the exact pre-round value
        deq = _np(prev).astype(np.float64)
        got4 = _np(ours[4].invert(prev))
        want4 = _np(theirs[4].invert(_np(prev)))
        op, mag = _operator(d, tr, inverse=True)
        v = np.real(_unblocks(_blocks(deq, d) @ op.T, *deq.shape, d))
        bound = _unblocks((L + 16) * EPS32 * (np.abs(_blocks(deq, d))
                                              @ mag.T), *deq.shape, d)
        assert got4.dtype == np.int32
        _assert_tie_equal(got4, want4, _ties(v, bound), "invert[4]")
        prev = got4
        for o, t in zip(reversed(ours[:4]), reversed(theirs[:4])):
            got = o.invert(torch.from_numpy(np.asarray(prev)))
            _assert_same(got, t.invert(np.asarray(prev)),
                         f"invert[{o.step_index}]")
            prev = _np(got)


@pytest.mark.parametrize("w,h,bs,d,tr,q", [CONFIGS[1], CONFIGS[4]])
def test_band_steps_equal_the_band_api(w, h, bs, d, tr, q):
    """compress_band_steps gives compress_band's bytes and
    decompress_band_steps decompress_band's plane: in the f64 parity mode
    exactly (and jpeg_tpu's), in f32 within the tie contract."""
    cfg, jcfg = _pair(w, h, bs, d, tr, q)
    a = _plane(77, h, w)
    f64 = torch.float64
    blob = steps.compress_band_steps(a, cfg, "cpu", f64)
    assert blob == jpeg_tpu_torch.compress_band(a, cfg, f64, device="cpu")
    assert blob == jsteps.compress_band_steps(a, jcfg)
    plane = steps.decompress_band_steps(blob, cfg, "cpu", f64)
    np.testing.assert_array_equal(
        plane, jpeg_tpu_torch.decompress_band(blob, cfg, f64, device="cpu"))
    np.testing.assert_array_equal(plane,
                                  jsteps.decompress_band_steps(blob, jcfg))
    # f32: levels within the tie contract of the f64 reference
    from jpeg_tpu_torch.utils import parity
    blob32 = steps.compress_band_steps(a, cfg, "cpu")
    L, n = d * d, cfg.num_blocks
    ref, ties = parity.encode_reference_and_ties(cfg, a)
    lv32 = NC.decode_levels(blob32, n, L)
    parity.assert_tie_equal(lv32, ref, ties, "f32 steps levels")
    plane32 = steps.decompress_band_steps(blob32, cfg, "cpu")
    pref, pties = parity.decode_reference_and_ties(cfg, lv32)
    parity.assert_tie_equal(plane32, pref, pties, "f32 steps plane")


def test_missing_step_index_raises():
    with pytest.raises(steps.MissingStepIndexError):
        class Broken(steps.AlgorithmStep):  # noqa: F841
            pass
    assert [c.__name__ for c in steps.step_classes] == NAMES


def test_custom_step_registers_sorted():
    before = list(steps.step_classes)
    try:
        class Custom(steps.AlgorithmStep):
            step_index = 2.5

            def execute(self, array):
                return array * 1

            def invert(self, array):
                return array

        idx = steps.step_classes.index(Custom)
        assert steps.step_classes[idx - 1].step_index == 2
        assert steps.step_classes[idx + 1].step_index == 3
        cfg = Configuration(width=16, height=16,
                            quantization=QuantizationMethod("qtable"))
        a = _plane(3, 16, 16)
        # the spliced step runs in the pipeline, both ways
        blob = steps.compress_band_steps(a, cfg, "cpu", torch.float64)
        assert blob == jpeg_tpu_torch.compress_band(a, cfg, torch.float64,
                                                    device="cpu")
    finally:
        steps.step_classes[:] = before
    assert [c.__name__ for c in steps.step_classes] == NAMES


def test_apply_blockwise_and_blocks():
    cfg = Configuration(width=8, height=8, block_size=2)
    step = steps.Normalization(cfg, "cpu")
    a = np.arange(64, dtype=np.float64).reshape(8, 8)
    res = np.zeros((8, 8))
    out = step.apply_blockwise(a, lambda blk: blk * 2.0, 4, res)
    np.testing.assert_array_equal(out.numpy(), a * 2)
    np.testing.assert_array_equal(res, a * 2)
    assert [(y, x) for _, y, x in step.blocks(a, 4)] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert step.calculate_padding(3) == (1, 1)
    with pytest.raises(BadArrayShapeError):
        steps.Padding(Configuration(width=8, height=8, block_size=3),
                      "cpu").execute(np.zeros((2, 8, 8)))
    if not torch.cuda.is_available():     # the default device is "cuda"
        with pytest.raises(RuntimeError, match="cuda"):
            steps.Padding(cfg)


# ---------------------------------------------------------------------------
# Class-level API (tests/test_classic_api.py, tests/test_bitio.py)
# ---------------------------------------------------------------------------

RNG = np.random.default_rng(21)


def test_dct_and_zigzag_classes():
    dct = T.DCT(8)
    x = RNG.uniform(-100, 100, 8)
    np.testing.assert_allclose(dct.transform_1d_inverse(dct.transform_1d(x)),
                               x, rtol=1e-10)
    a = RNG.uniform(0, 255, (8, 8))
    np.testing.assert_array_equal(dct.transform_2d(a),
                                  jpeg_tpu.ops.transform.DCT(8).transform_2d(a))
    np.testing.assert_allclose(dct.transform_2d_inverse(dct.transform_2d(a)),
                               a, rtol=1e-10)
    for n in (2, 4, 8):
        np.testing.assert_array_equal(
            T.kron_operator(n), jpeg_tpu.ops.transform.kron_operator(n))
        np.testing.assert_array_equal(
            T.kron_inverse_operator(n),
            jpeg_tpu.ops.transform.kron_inverse_operator(n))
    z = T.Zigzag(3)
    block = np.arange(9).reshape(3, 3)
    order = z.zigzag_order(block)
    np.testing.assert_array_equal(order, [0, 1, 3, 6, 4, 2, 5, 7, 8])
    np.testing.assert_array_equal(z.restore(order).reshape(3, 3), block)
    with pytest.raises(BadArrayShapeError):
        z.zigzag_order(np.zeros((2, 2)))
    with pytest.raises(BadArrayShapeError):
        z.restore(np.zeros(4))


def test_quantizer_classes_equal_jpeg_tpu():
    a = RNG.uniform(-500, 500, (8, 8))
    for qname, params in (("none", {}), ("discard", {"keep": 3}),
                          ("divide", {"divisor": 7}), ("qtable", {})):
        ours = Q.quantizer_for(QuantizationMethod(qname, **params))
        theirs = jquantize.quantizer_for(
            jpeg_tpu.QuantizationMethod(qname, **params))
        assert type(ours).__name__ == type(theirs).__name__
        np.testing.assert_array_equal(ours.quantize(a), theirs.quantize(a))
        np.testing.assert_array_equal(ours.restore(a), theirs.restore(a))
    dq = Q.DiscardingQuantizer(keep=2).quantize(a)
    assert dq[2:].sum() == 0 and dq[:, 2:].sum() == 0
    dv = Q.DivisionQuantizer(divisor=40)
    np.testing.assert_array_equal(dv.restore(dv.quantize(a)),
                                  np.round(a / 40.0) * 40)
    assert isinstance(Q.quantizer_for(QuantizationMethod("divide",
                                                         divisor=3)),
                      Q.DivisionQuantizer)


def test_exact_block_transforms_equal_jpeg_tpu():
    blk = RNG.uniform(0, 255, (3, 2, 8, 8))
    jt = jpeg_tpu.ops.transform
    import jax.numpy as jnp
    for ours, theirs, x in (
            (T.exact_dct2_blocks, jt.exact_dct2_blocks, blk),
            (T.exact_idct2_blocks, jt.exact_idct2_blocks, blk),
            (T.exact_fft2_blocks, jt.exact_fft2_blocks,
             blk.astype(np.complex128)),
            (T.exact_ifft2_blocks, jt.exact_ifft2_blocks,
             blk.astype(np.complex128))):
        np.testing.assert_array_equal(ours(x, 8),
                                      np.asarray(theirs(jnp.asarray(x), 8)))


def test_bits_and_bit_coders():
    b = Bits("0100001111")
    assert b.to01() == "0100001111" and len(b) == 10
    c = Bits()
    c.frombytes(b.tobytes())
    assert c.to01()[:10] == b.to01()
    assert (Bits("01") + Bits("10")).to01() == "0110"
    enc = BitEncoder()
    assert enc.encode_unsigned(4).to01() == "100"
    assert enc.pad_bitstring(enc.encode_unsigned(4)).to01() == "0100"
    assert enc.encode_signed(6).to01() == "1110"      # '1' = positive
    assert enc.encode_signed(-6).to01() == "0110"
    d = BitDecoder(Bits("0100" + "0011" + "110" + "0" * 13))
    assert d.decode_unsigned(4) == 4 and d.decode_unsigned(4) == 3
    assert d.decode_signed(3) == 2
    d.skip_padding()
    assert d._pos == 16 and not d.is_end()


def test_runlength_codes_equal_jpeg_tpu():
    codes = RunLengthCode.encode(33, -5)
    assert [c.as_tuple() for c in codes] == [(15, 0, 0), (15, 0, 0),
                                             (3, 4, -5)]
    assert codes[0].as_bitstring().to01() == "11110000"
    assert codes[2].as_bitsring().to01() == "0011" + "0100" + "0101"
    assert RunLengthCode.EOB().as_bitstring().to01() == "00000000"
    assert RunLengthCode(15, 0, 0).decode() == [0] * 15
    for run, amp in [(0, 1), (3, -5), (14, 100), (15, 7), (33, -16383)]:
        ours = RunLengthCode.encode(run, amp)
        theirs = jbitio.RunLengthCode.encode(run, amp)
        assert [c.as_tuple() for c in ours] == [c.as_tuple() for c in theirs]
        assert [c.as_bitstring().to01() for c in ours] == \
            [c.as_bitstring().to01() for c in theirs]
    for bad in [(1, 0, 0), (16, 0, 0), (0, 16, 0), (0, 0, 5)]:
        with pytest.raises(BadRleCodeError):
            RunLengthCode(*bad)
    z = np.zeros(64)
    z[[0, 3, 40, 63]] = [12.4, -7, 3, 1]
    ours = RunLengthBlock(64).encode(z)
    assert [c.as_tuple() for c in ours] == \
        [c.as_tuple() for c in jbitio.RunLengthBlock(64).encode(z)]
    want = np.zeros(64)
    want[[0, 3, 40, 63]] = [12, -7, 3, 1]
    np.testing.assert_array_equal(RunLengthBlock(64).decode(ours), want)


@pytest.mark.parametrize("L,density", [(64, 0.15), (16, 0.6), (64, 0.0)])
def test_tuple_codec_equals_jpeg_tpu_and_the_stream(L, density):
    rng = np.random.default_rng(L)
    lv = np.where(rng.random((12, L)) < density,
                  rng.integers(-16383, 16384, (12, L)), 0).astype(np.int32)
    lv[0, L - 1] = 9                         # a run past 15 zeros
    tuples = TU.encode_levels_to_tuples(lv)
    assert tuples == jtuples.encode_levels_to_tuples(lv)
    data = TU.tuples_to_bytes(tuples)
    assert data == jtuples.tuples_to_bytes(tuples) == NC.encode_levels(lv)
    assert TU.bytes_to_tuples(data) == jtuples.bytes_to_tuples(data)
    np.testing.assert_array_equal(
        TU.decode_tuples_to_levels(TU.bytes_to_tuples(data), 12, L), lv)
    with pytest.raises(BadStreamError):
        TU.decode_tuples_to_levels(tuples, 11, L)
    with pytest.raises(BadStreamError):
        TU.bytes_to_tuples(data + b"\xf5")      # truncated amplitude
    with pytest.raises(BadRleCodeError):
        TU.validate_code(3, 0, 0)


def test_array_utils_equal_jpeg_tpu():
    a = np.arange(12).reshape(3, 4)
    p = UA.pad_array(a, 4)
    assert p.shape == (4, 4)
    np.testing.assert_array_equal(p, jarrays.pad_array(a, 4))
    np.testing.assert_array_equal(p[3], p[2])          # edge replication
    np.testing.assert_array_equal(UA.undo_pad_array(p, (1, 0)), a)
    blocks = UA.split_into_blocks(np.arange(15).reshape(3, 5), 2)
    np.testing.assert_array_equal(
        blocks, jarrays.split_into_blocks(np.arange(15).reshape(3, 5), 2))
    np.testing.assert_array_equal(UA.inflate(np.array([[1, 2]]), 2),
                                  [[1, 1, 2, 2], [1, 1, 2, 2]])
    assert UA.calculate_padding(a, 4) == jarrays.calculate_padding(a, 4)
    b = np.arange(48).reshape(6, 8)
    split = UA.split_into_blocks(b, 2)
    for j, col in UA.block_columns(b, 2):
        for y in range(3):
            np.testing.assert_array_equal(
                UA.extract_nth_block(col, 2, y), split[y, j])
    assert UA.band_to_array(np.ones((2, 3), np.uint8)).dtype == np.int64
    with pytest.raises(BadArrayShapeError):
        UA.pad_array(np.zeros(4), 2)
    with pytest.raises(EmptyArrayError):
        UA.pad_array(np.zeros((0, 4)), 2)
