"""The Hopper designs of K5 (``encode_blocks``: the ragged-DFT encode on
the 3xTF32 tensor-core product) and K3 (``decode_stream_blocks``: a tiled
shared-memory stream decode), modelled in numpy against their plain
versions and jpeg_tpu.

The CUDA kernels run only on a GPU, where chip_smoke.py holds them against
their plain versions and an f64 reference.  Here:

* K5 (``csrc/encode_blocks.cu`` on ``csrc/tc_product.cuh``): the TF32
  split of non-integer f32 values (pixel means of 2x2 and 3x3 blocks, the
  DFT and DCT operators) leaves at most the residual the source states;
  the source's error bound B(K) stays below the contract's K + 16; both
  tile shapes' constants, strides and shared memory, read from the
  source; a numpy model of the split product in the kernel's order (K
  zero-padded to the 32-wide slices, each k8 step's three products
  truncated to f32 as the source assumes the tensor cores may, the steps
  added in f32), then the epilogue in f32, stays within B(K) 2**-23
  sum|terms| of the exact sum and, put in K5's place inside
  ``BandEncoder``'s ``blocks`` branch, holds the +-1-at-provable-ties
  contract against jpeg_tpu's f32 ragged-DFT encode (the interpret-mode
  Pallas ``encode_blocks``, as jpeg_tpu's own tests run it) and the f64
  reference.
* K3 (``csrc/decode_stream.cu``): the tile plan and its constants (read
  from the source); the halo against the encoder's longest blocks at L =
  64 and 576; a numpy model of the tiled decode (the window from the
  tile's first start to its last start plus the halo, at most the span
  budget; a 64-bit bit buffer refilled a big-endian word at a time, from
  the window or, outside it, from the stream) is bit-equal to
  ``decode_stream_blocks_plain`` on real, dense, all-EOB and padded
  streams and on garbage starts (random, descending, P, P + 1 and
  beyond), reads outside the window only where the span overflows the
  budget or the starts are garbage, and equals jpeg_tpu's interpret-mode
  ``decode_stream_rows`` on the same streams.

Every comparison is exact except the tie contract, whose bound
``(K + 16) 2**-23 sum|terms|`` (``utils/parity.py``) is unchanged.
"""
import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_tpu.config import Configuration as JConfiguration
from jpeg_tpu.config import QuantizationMethod as JQuantizationMethod
from jpeg_tpu.entropy import device_codec as JDC
from jpeg_tpu.ops import band as jband
from jpeg_tpu.ops import pallas_kernels as PK
from jpeg_tpu.utils import parity as jparity

from jpeg_tpu_torch.config import Configuration, QuantizationMethod
from jpeg_tpu_torch.entropy import numpy_codec as NC
from jpeg_tpu_torch.ops import kernels as K
from jpeg_tpu_torch.ops import quantize as Q
from jpeg_tpu_torch.ops import transform as T
from jpeg_tpu_torch.ops.band import BandEncoder

torch.set_num_threads(2)

CSRC = os.path.join(os.path.dirname(K.__file__), os.pardir, "csrc")
EPS32 = 2.0 ** -23


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


TC = _source("tc_product.cuh")
ENC = _source("encode_blocks.cu")
DEC = _source("decode_stream.cu")


def _const(src, name):
    return int(re.search(rf"constexpr u?int(?:32_t)? {name} = (\w+?)u?;",
                         src)[1], 0)


def _shift_const(src, name):
    a, b = re.search(rf"constexpr int {name} = (\d+) << (\d+);", src).groups()
    return int(a) << int(b)


# ---------------------------------------------------------------------------
# K5: the split, the bound, the tiles
# ---------------------------------------------------------------------------

MASK = _const(TC, "kTf32Mask")
HALF = _const(TC, "kTf32Round")
RESIDUAL = 2.0 ** int(re.search(
    r"\|x - x_hi - x_lo\| <= 2\^(-\d+) \|x\|", TC)[1])
B_CONST = [float(v) for v in re.search(
    r"B\(K\) = ([\d.]+) \(min\(K, 8\) \+ 2\) \+ ([\d.]+) ceil\(K / 8\) "
    r"\+ ([\d.]+)", TC).groups()]
BK = _const(TC, "kBK")
STAGES = _const(TC, "kStages")
THREADS = _const(TC, "kThreads")
WM, WN = _const(TC, "kWM"), _const(TC, "kWN")
SHAPES = {name: tuple(int(v or WN) for v in re.search(
    rf"using {name} = Shape<(\d+), (\d+)(?:, (\d+))?>;", TC).groups())
    for name in ("Wide", "Tall", "W96")}


def tf32(x):
    """The kernel's TF32 rounding: ``(bits + kTf32Round) & kTf32Mask``."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + HALF) & MASK).astype(np.uint32).view(np.float32)


def split(x):
    x = np.asarray(x, np.float32)
    hi = tf32(x)
    return hi, tf32(x - hi)


def bound_factor(K_):
    c1, c2, c3 = B_CONST
    return c1 * (min(K_, 8) + 2) + c2 * math.ceil(K_ / 8) + c3


def _pixel_means(rng, n, L, bs):
    """f32 means of bs x bs pixel blocks, as ``subsample_fast`` gives
    them: integer sums over bs**2."""
    return (rng.integers(0, 255 * bs * bs + 1, (n, L)) / (bs * bs)).astype(
        np.float32)


SPLIT_VALUES = ["means_bs2", "means_bs3", "dft_d3", "dft_d8", "dft_d24",
                "dct_d8"]


@pytest.mark.parametrize("kind", SPLIT_VALUES)
def test_split_of_non_integer_values_leaves_the_stated_residual(kind):
    rng = np.random.default_rng(len(kind))
    if kind.startswith("means"):
        x = _pixel_means(rng, 500, 64, int(kind[-1])).ravel()
        assert (x != np.round(x)).any()
    else:
        d = int(kind.split("_d")[1])
        op = (T.dft_encode_operator(d) if kind.startswith("dft")
              else T.encode_operator(d))
        x = op.astype(np.float32).ravel()
    hi, lo = split(x)
    x64 = x.astype(np.float64)
    assert not (hi.view(np.uint32) & ~np.uint32(MASK)).any()
    assert (np.abs(x64 - hi) <= 2.0 ** -11 * np.abs(x64)).all()
    res = x64 - hi.astype(np.float64) - lo.astype(np.float64)
    assert (np.abs(res) <= RESIDUAL * np.abs(x64)).all()
    # x - x_hi is exact in f32, so the two pieces are all the split drops
    np.testing.assert_array_equal(
        (x - hi).astype(np.float64), x64 - hi.astype(np.float64))


def test_bound_of_the_split_is_inside_the_contract_up_to_1024():
    assert bound_factor(64) == pytest.approx(20.1, abs=0.05)
    assert bound_factor(576) == pytest.approx(52.8, abs=0.05)
    assert all(bound_factor(K_) <= K_ + 16 for K_ in range(1, 1025))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_tile_shape_constants_and_strides(name):
    BM, BN, wn = SHAPES[name]
    a_stride = BK + int(re.search(r"kAStride = kBK \+ (\d+);", TC)[1])
    b_stride = BN + int(re.search(r"kBStride = BN \+ (\d+);", TC)[1])
    warps_m, warps_n = BM // WM, BN // wn
    assert BM % WM == 0 and BN % wn == 0 and wn % 8 == 0
    assert 32 * warps_m * warps_n == THREADS == 256
    # every fragment load free of bank conflicts: the g (8) x t (4) lanes of
    # an A fragment fall in 32 banks at a stride of 4 mod 32, B's at 8
    assert a_stride % 32 == 4 and b_stride % 32 == 8
    for stride, per_g, per_t in ((a_stride, a_stride, 1),
                                 (b_stride, 1, b_stride)):
        banks = {(g * per_g + t * per_t) % 32 for g in range(8)
                 for t in range(4)}
        assert len(banks) == 32, stride
    smem = STAGES * (BM * a_stride + BK * b_stride) * 4
    assert smem == {"Wide": 79872, "Tall": 82944, "W96": 67584}[name]
    assert 2 * smem <= 228 * 1024 - 2 * 1024      # two blocks an SM
    for out_bytes in (1, 4):                        # uint8 / int32, f32
        assert BM * (BN + 16 // out_bytes) * out_bytes <= smem
    assert BN * 4 % 16 == 0 and BN % 16 == 0        # 16-byte row chunks


def test_k5_takes_the_tall_tile_up_to_64_columns_and_k4_the_wide():
    assert SHAPES == {"Wide": (64, 128, 32), "Tall": (128, 64, 32),
                      "W96": (64, 96, 24)}
    assert "L <= jt::tc::Tall::kBN" in ENC
    assert "tc_product<S, kVec>" in ENC and "__uint_as_float(word)" in ENC
    assert "W96" not in ENC
    # K4 takes the tile that computes the fewest columns, the wide one on
    # a tie (its bs 1 product at the combined operator's 9,216 columns);
    # tests/test_torch_kernel_design.py models the choice
    dec = _source("decode_blocks.cu")
    assert "if (wide <= w96 && wide <= tall)" in dec
    assert "tc_product<S, kVec>" in dec and "InflateStore{{" in dec
    assert "jt::tc::RowStore{}" in dec
    assert "class Store = RowStore" in TC
    # the epilogue divides, never multiplies by a reciprocal
    assert "__fdiv_rn(__fmul_rn(acc, __ldg(mul + c)), __ldg(div + c))" in ENC
    assert not os.path.exists(os.path.join(CSRC, "tiled_product.cuh"))
    # at L = 64 the wide tile would compute 128 columns for 64
    for L, name in ((64, "Tall"), (9, "Tall"), (576, "Wide")):
        BM, BN, _ = SHAPES[name]
        used = L / (-(-L // BN) * BN)
        assert used >= (1.0 if L == 64 else 0.14), (L, used)


def _trunc32(x):
    """f64 -> f32 rounding toward zero (the tensor cores' assumed sum)."""
    t = x.astype(np.float32)
    over = np.abs(t.astype(np.float64)) > np.abs(x)
    t[over] = np.nextafter(t[over], np.float32(0))
    return t


def model_sums(a32, b32):
    """The kernel's f32 sums of a32 (N, K) @ b32 (K, L): K zero-padded to
    whole kBK slices; per k8 step d = a_hi b_hi + (a_hi b_lo + (a_lo b_hi +
    0)), each product sum truncated to f32, then acc += d in f32."""
    n, K_ = a32.shape
    kp = -(-K_ // BK) * BK
    a = np.zeros((n, kp), np.float32)
    b = np.zeros((kp, b32.shape[1]), np.float32)
    a[:, :K_], b[:K_] = a32, b32
    ah, al = (p.astype(np.float64) for p in split(a))
    bh, bl = (p.astype(np.float64) for p in split(b))
    acc = np.zeros((n, b.shape[1]), np.float32)
    for k0 in range(0, kp, 8):
        s = slice(k0, k0 + 8)
        d = _trunc32(al[:, s] @ bh[s])
        d = _trunc32(ah[:, s] @ bl[s] + d)
        d = _trunc32(ah[:, s] @ bh[s] + d)
        acc = acc + d
    return acc


def model_encode_blocks(x, op_t, mul, div, mask):
    """K5 on the model product: the f32 epilogue rint((acc * mul) / div)
    * mask, each operation rounded to f32 as the kernel's __fmul_rn,
    __fdiv_rn, rintf."""
    acc = model_sums(x.numpy(), op_t.numpy())
    q = (acc * mul.numpy()) / div.numpy()
    assert q.dtype == np.float32
    return torch.from_numpy((np.rint(q) * mask.numpy()).astype(np.int32))


@pytest.mark.parametrize("d,bs", [(3, 3), (8, 2), (8, 3), (24, 1)])
def test_model_product_within_the_stated_bound_on_pixel_means(d, bs):
    rng = np.random.default_rng(d * 10 + bs)
    L = d * d
    a32 = _pixel_means(rng, 160, L, bs)
    op_t = T.dft_encode_operator(d).T.astype(np.float32)
    exact = a32.astype(np.float64) @ op_t.astype(np.float64)
    terms = np.abs(a32.astype(np.float64)) @ np.abs(op_t.astype(np.float64))
    err = np.abs(model_sums(a32, op_t).astype(np.float64) - exact)
    assert (err <= bound_factor(L) * EPS32 * terms + 1e-300).all()
    # and well inside: the bound is a worst case
    assert err.max() > 0


# Ragged DFT configurations: the ones BandEncoder's `blocks` branch (K5)
# takes, at small size.
RAGGED = {
    "bs3_none": (23, 37, 3, 8, "none", {}),
    "bs3_qtable": (25, 41, 3, 8, "qtable", {}),
    "bs2_divide3": (21, 35, 2, 8, "divide", {"divisor": 3}),
    "bs3_discard": (23, 37, 3, 8, "discard", {"keep": 3}),
    "bs4_d24_divide1000": (50, 70, 4, 24, "divide", {"divisor": 1000}),
    "bs1_d3_none": (11, 13, 1, 3, "none", {}),
}


def _band(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    b = (128 + 90 * np.sin(x / (5 + seed)) * np.cos(y / 7)
         + 14 * rng.standard_normal((h, w)))
    return np.clip(b, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("name", sorted(RAGGED))
def test_model_product_holds_the_tie_contract_against_jpeg_tpu(
        name, monkeypatch):
    h, w, bs, d, qn, qp = RAGGED[name]
    kw = dict(width=w, height=h, block_size=bs, dct_size=d, transform="DFT")
    tcfg = Configuration(**kw, quantization=QuantizationMethod(qn, **qp))
    jcfg = JConfiguration(**kw, quantization=JQuantizationMethod(qn, **qp))
    bands = np.stack([_band(h, w, s) for s in range(3)])
    enc = BandEncoder(tcfg)
    assert enc.branch == "blocks"
    monkeypatch.setattr(K, "encode_blocks", model_encode_blocks)
    got = enc(torch.from_numpy(bands)).numpy()
    f = jband.make_encode(jband.config_key(jcfg), "float32", True)
    for b in range(3):
        want = np.asarray(f(jnp.asarray(bands[b])))
        ref, ties = jparity.encode_reference_and_ties(jcfg, bands[b])
        jparity.assert_tie_equal(got[b], want, ties, f"{name} band {b}")
        jparity.assert_tie_equal(got[b], ref, ties, f"{name} f64 band {b}")


def test_encode_blocks_sums_on_the_cpu_is_the_full_f32_product():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_pixel_means(rng, 70, 64, 3))
    op_t = torch.from_numpy(np.ascontiguousarray(
        T.dft_encode_operator(8).T, np.float32))
    sums = K.encode_blocks_sums(x, op_t)
    assert sums.dtype == torch.float32 and sums.shape == (70, 64)
    mul, div, mask = (torch.from_numpy(v.astype(np.float32)) for v in
                      Q.epilogue_vectors(QuantizationMethod("none"), 8))
    np.testing.assert_array_equal(
        Q.epilogue(sums, mul, div, mask).to(torch.int32).numpy(),
        K.encode_blocks_plain(x, op_t, mul, div, mask).numpy())
    with pytest.raises(ValueError, match="op_t"):
        K.encode_blocks_sums(x, op_t[:63].contiguous())
    with pytest.raises(ValueError, match="float32"):
        K.encode_blocks_sums(x.double(), op_t)
    before = K.launch_counts()
    K.encode_blocks_sums(x, op_t)
    assert K.launch_counts() == before


# ---------------------------------------------------------------------------
# K3: the tiled decode
# ---------------------------------------------------------------------------

TILE_MAX = _const(DEC, "kThreads")
LEVEL_BYTES = K.DECODE_LEVEL_BYTES
SPAN_BYTES = _shift_const(DEC, "kSpanBytes")
SMEM_MAX = _shift_const(DEC, "kMaxSmem")


def test_tile_constants_are_the_wrappers():
    assert (TILE_MAX, SPAN_BYTES) == (K.DECODE_TILE_MAX, K.DECODE_SPAN_BYTES)
    assert SMEM_MAX == 227 * 1024
    assert "__launch_bounds__(kThreads)" in DEC
    assert "decode_stream_kernel<<<static_cast<unsigned>(tiles), kThreads," \
        in DEC
    # one launch a call: the wrapper allocates with torch.empty
    src = open(K.__file__).read()
    body = src[src.index("def _decode_stream("):
               src.index("def decode_stream_blocks(")]
    assert "torch.empty((n, L)" in body and "torch.zeros" not in body


@pytest.mark.parametrize("L,tile", [(1, 128), (9, 128), (64, 32),
                                    (576, 4), (1024, 2), (K.DECODE_MAX_L, 1)])
def test_plan_fits_the_level_budget_and_shared_memory(L, tile):
    plan = K.decode_stream_plan(L)
    assert plan.tile == tile
    assert plan.tile == 1 or 4 * L * plan.tile <= LEVEL_BYTES
    assert plan.tile == TILE_MAX or 4 * L * plan.tile * 2 > LEVEL_BYTES
    assert plan.halo % 16 == 0 and plan.halo >= K.block_max_bytes(L) + 8
    assert K._ceil16(4 * L * plan.tile) + SPAN_BYTES <= SMEM_MAX


def test_wrapper_rejects_l_past_the_largest_tile():
    s = torch.zeros(4, dtype=torch.uint8)
    st = torch.zeros(1, dtype=torch.int64)
    for L in (0, K.DECODE_MAX_L + 1):
        with pytest.raises(ValueError, match="L must be"):
            K.decode_stream_blocks(s, st, L)


@pytest.mark.parametrize("L", [64, 576])
def test_halo_covers_the_encoders_longest_blocks(L):
    """Blocks of every coefficient at +-16383 are the longest the encoder
    writes: exactly ``block_max_bytes(L)`` bytes (185 at L = 64, 1,657 at
    L = 576); a walk of one reads at most 8 bytes past its EOB, inside the
    halo."""
    rng = np.random.default_rng(L)
    lv = rng.choice([-16383, 16383], (5, L)).astype(np.int32)
    data = NC.encode_levels(lv)
    assert len(data) == 5 * K.block_max_bytes(L)
    assert K.block_max_bytes(L) == {64: 185, 576: 1657}[L]
    starts = np.arange(5) * K.block_max_bytes(L)
    plan = K.decode_stream_plan(L)
    got, reads = model_decode(data, starts, L, plan, span=1 << 30)
    np.testing.assert_array_equal(got, lv)
    assert reads["global"] == 0
    assert reads["last"] - K.block_max_bytes(L) <= plan.halo - 8
    # the real budget: a tile of such blocks overflows it at L = 64
    span = K.block_max_bytes(L) * min(plan.tile, 5)
    assert span + plan.halo > SPAN_BYTES or L == 64


def model_decode(data, starts, L, plan, span=SPAN_BYTES):
    """csrc/decode_stream.cu in numpy.  Returns the (N, L) levels and the
    words the walks read from the window and from the stream, and the
    furthest byte a walk read past its tile's last start (``last``)."""
    raw = np.frombuffer(bytes(data), np.uint8)
    nbytes = raw.shape[0]
    starts = [int(s) for s in starts]
    n = len(starts)
    out = np.zeros((n, L), np.int32)
    reads = {"window": 0, "global": 0, "last": 0}

    def byte(b):
        return int(raw[b]) if 0 <= b < nbytes else 0

    for i0 in range(0, n, plan.tile):
        rows = min(plan.tile, n - i0)
        first, last = starts[i0], starts[i0 + rows - 1]
        lo = min(max(first, 0), nbytes) & ~15
        want = (last - lo if last > lo else 0) + plan.halo
        count = K._ceil16(want) if want < span else span
        window = bytes(byte(lo + i) for i in range(count))

        def word(w):
            off = 4 * w - lo
            if 0 <= off < count:
                reads["window"] += 1
                return int.from_bytes(window[off:off + 4], "big")
            reads["global"] += 1
            return int.from_bytes(bytes(byte(4 * w + j) for j in range(4)),
                                  "big")

        for j in range(rows):
            start = starts[i0 + j]
            w = start >> 2
            skip = 8 * (start & 3)
            buf = (word(w) << (32 + skip)) & (2 ** 64 - 1)
            w += 1
            nbits, widx = 32 - skip, 0
            for _ in range(L + L // 15 + 2):
                if nbits < 32:
                    buf |= word(w) << (32 - nbits)
                    w += 1
                    nbits += 32
                win = buf >> 32
                run, size = win >> 28, (win >> 24) & 0xF
                if size == 0 and run == 0:
                    break
                used = 8
                if size == 0 and run == 15:
                    widx += 15
                else:
                    nmag = max(size - 1, 0)
                    mag = (win >> (23 - nmag)) & ((1 << nmag) - 1)
                    wt = widx + run
                    if wt < L:
                        out[i0 + j, wt] = mag if (win >> 23) & 1 else -mag
                        widx = wt + 1
                    used += size
                buf = (buf << used) & (2 ** 64 - 1)
                nbits -= used
            reads["last"] = max(reads["last"], 4 * w - last)
    return out, reads


def _levels(kind, n, L, seed):
    rng = np.random.default_rng(seed)
    if kind == "sparse":            # the main path's kind of blocks
        lv = np.where(rng.random((n, L)) < 0.12,
                      rng.integers(-60, 61, (n, L)), 0)
        lv[:, 0] = rng.integers(-300, 301, n)
    elif kind == "dense":           # every coefficient at +-16383
        lv = rng.choice([-16383, 16383], (n, L))
    elif kind == "eob":             # all-EOB blocks
        lv = np.zeros((n, L))
    else:                           # mixed: runs of 15, 16, dense, EOB
        lv = np.where(rng.random((n, L)) < 0.15,
                      rng.integers(-900, 901, (n, L)), 0)
        lv[::5] = 0
        lv[1::7, L - 1] = 16383
        lv[2::7, :L - 1] = 0
        lv[3::7] = rng.choice([-16383, 1, -1], (len(lv[3::7]), L))
    return lv.astype(np.int32)


def _plain(data, starts, L):
    return K.decode_stream_blocks_plain(
        torch.frombuffer(bytearray(data), dtype=torch.uint8) if data else
        torch.zeros(0, dtype=torch.uint8),
        torch.from_numpy(np.ascontiguousarray(starts, np.int64)), L).numpy()


# (kind, N, L, small tiles): N around the tile, L = 9 / 64 / 576
STREAMS = [("sparse", 300, 64, False), ("sparse", 129, 64, False),
           ("sparse", 1, 64, False), ("mixed", 257, 64, True),
           ("sparse", 40, 576, False), ("mixed", 33, 576, True),
           ("mixed", 300, 9, False), ("eob", 200, 64, False),
           ("dense", 130, 64, False), ("dense", 20, 576, False)]


@pytest.mark.parametrize("kind,n,L,small", STREAMS)
def test_tiled_model_equals_the_plain_version(kind, n, L, small):
    lv = _levels(kind, n, L, n + L)
    data = NC.encode_levels(lv) + bytes(13)           # buffer longer
    starts = NC.scan_offsets(data[:-13], n, L)
    plan = K.decode_stream_plan(L)
    if small:
        plan = plan._replace(tile=max(1, plan.tile // 8))
    got, reads = model_decode(data, starts, L, plan)
    np.testing.assert_array_equal(got, lv)
    np.testing.assert_array_equal(got, _plain(data, starts, L))
    tile_bytes = [int(starts[min(i + plan.tile, n) - 1]) - int(starts[i])
                  for i in range(0, n, plan.tile)]
    if max(tile_bytes) + plan.halo <= SPAN_BYTES:
        assert reads["global"] == 0                     # staged span only
    else:
        assert kind == "dense" and reads["global"] > 0  # over the budget


GARBAGE = ["random", "descending", "P", "P+1", "beyond", "mixed"]


@pytest.mark.parametrize("how", GARBAGE)
@pytest.mark.parametrize("L", [64, 576])
def test_tiled_model_on_garbage_starts(how, L):
    """A device scan's starts before its check is read: out of order,
    past the stream and far past it, a tile of one block each way."""
    n = 150
    lv = _levels("mixed", n, L, 5)
    data = NC.encode_levels(lv)
    P = len(data)
    rng = np.random.default_rng(L + len(how))
    starts = {"random": rng.integers(0, P + 2, n),
              "descending": np.sort(rng.integers(0, P + 2, n))[::-1],
              "P": np.full(n, P), "P+1": np.full(n, P + 1),
              "beyond": rng.integers(P, P + (1 << 40), n),
              "mixed": np.where(rng.random(n) < 0.5,
                                NC.scan_offsets(data, n, L),
                                rng.integers(0, 2 * P, n))}[how]
    plan = K.decode_stream_plan(L)
    got, reads = model_decode(data, starts, L, plan)
    np.testing.assert_array_equal(got, _plain(data, starts, L))
    if how in ("P", "P+1", "beyond"):
        assert not got.any()                            # all EOB
    if how in ("descending", "beyond"):
        assert reads["global"] > 0


@pytest.mark.parametrize("kind,L", [("sparse", 64), ("mixed", 64),
                                    ("mixed", 16)])
def test_tiled_model_equals_pallas_decode_stream_rows(kind, L, monkeypatch):
    """jpeg_tpu's decode (the overlap-table rows, then the interpret-mode
    Pallas ``decode_stream_rows``, tiles of 64) on the same stream."""
    monkeypatch.setattr(PK, "DEC_TILE", 64)
    n = 70
    lv = _levels(kind, n, L, 21)
    data = NC.encode_levels(lv)
    starts = NC.scan_offsets(data, n, L)
    pad = bytes(data) + bytes(-len(data) % 4)
    want = np.asarray(JDC._decode_stream_pallas(
        jnp.asarray(np.frombuffer(pad, np.uint8)),
        jnp.asarray(starts.astype(np.int32)), L, 0, sort=False))
    got, _ = model_decode(data, starts, L, K.decode_stream_plan(L))
    np.testing.assert_array_equal(want, lv)
    np.testing.assert_array_equal(got, want)
