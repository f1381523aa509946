"""The Hopper designs of K4 (``decode_blocks``: a TF32 tensor-core product
with f32 accuracy) and K2 (``deposit_rows``: the prefix sum fused into the
deposit), modelled in numpy against their plain versions and jpeg_tpu.

The CUDA kernels run only on a GPU, where chip_smoke.py holds them against
their plain versions and an f64 reference.  Here:

* K4's split (``csrc/tc_product.cuh``): TF32 rounding as the kernel does it
  (round half away from zero at the source's ``kTf32Mask``, as
  ``cvt.rna.tf32.f32`` does, by adding ``kTf32Round`` to the bits); integers below 2**22 split exactly into two pieces, and
  below 2**24 leave the residual the source states (three pieces are exact
  there); every decode operator's pieces sum back to it within the
  residual the source states; the source's error bound B(K) stays below
  the contract's K + 16.  A numpy model of the kernel's product (three
  TF32 piece products a k8 step, each step's sum truncated to f32 as the
  source assumes the tensor cores may, the steps added in f32) stays within
  B(K) 2**-23 sum|terms| of the exact sum, and, put in K4's place inside
  ``BandDecoder``, holds the +-1-at-provable-ties contract against
  jpeg_tpu's f32 decode and the f64 reference in the main path's, bs 4 /
  5, d 24 and DFT configurations.
* K4's tile plan and store (``csrc/decode_blocks.cu``): the shape that
  computes the fewest columns (whole d-pixel rows a tile where bs > 1), and
  a numpy model of both stores (16-byte chunks of pixels replicated by the
  source's byte-permute selectors, or pixel by pixel) that writes every
  output byte once and gives ``inflate_blocks`` of the pixels.
* K2's work assignment (``csrc/compact.cu``): tiles of ``kTileBlocks``
  blocks, tile totals, the warp-wide look-back over published prefixes in
  any order of the tiles, tile-relative offsets, aligned output words
  assembled by funnel shifts across blocks, the edge bytes around them and
  the zero tail; every byte of the buffer is written exactly once, and the
  buffer equals ``deposit_rows_plain`` on random block bytes with 1-byte
  and 4W-byte blocks and a cap below, at and above the stream's length.

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
from jpeg_tpu.ops import band as jband
from jpeg_tpu.utils import parity as jparity

from jpeg_tpu_torch.config import Configuration, QuantizationMethod
from jpeg_tpu_torch.entropy import numpy_codec as NC
from jpeg_tpu_torch.ops import kernels as K
from jpeg_tpu_torch.ops import transform as T
from jpeg_tpu_torch.ops.band import BandDecoder

torch.set_num_threads(2)

CSRC = os.path.join(os.path.dirname(K.__file__), os.pardir, "csrc")
EPS32 = 2.0 ** -23


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


TC = _source("tc_product.cuh")
COMPACT = _source("compact.cu")

# ---------------------------------------------------------------------------
# K4: the TF32 split
# ---------------------------------------------------------------------------

MASK = int(re.search(r"constexpr uint32_t kTf32Mask = (0x[0-9a-f]+)u;", TC)[1],
           16)
HALF = int(re.search(r"constexpr uint32_t kTf32Round = (0x[0-9a-f]+)u;",
                     TC)[1], 16)
RESIDUAL = 2.0 ** int(re.search(
    r"\|x - x_hi - x_lo\| <= 2\^(-\d+) \|x\|", TC)[1])
B_CONST = [float(v) for v in re.search(
    r"B\(K\) = ([\d.]+) \(min\(K, 8\) \+ 2\) \+ ([\d.]+) ceil\(K / 8\) "
    r"\+ ([\d.]+)", TC).groups()]


def tf32(x):
    """The kernel's TF32 rounding of f32 values: round half away from zero
    to the bits ``kTf32Mask`` keeps (``(x + kTf32Round) & kTf32Mask``)."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + HALF) & MASK).astype(np.uint32).view(np.float32)


def split(x):
    x = np.asarray(x, np.float32)
    hi = tf32(x)
    return hi, tf32(x - hi)


def bound_factor(K_):
    c1, c2, c3 = B_CONST
    return c1 * (min(K_, 8) + 2) + c2 * math.ceil(K_ / 8) + c3


def test_the_kernel_rounds_as_cvt_rna_on_the_bits():
    """The source rounds with two integer operations: half of the last kept
    bit's weight added to the magnitude's bits, then the dropped bits
    cleared (cvt.rna.tf32.f32's rounding, half away from zero)."""
    assert MASK == 0xffffe000 and HALF == ((~MASK & 0xffffffff) + 1) >> 1
    assert "(__float_as_uint(x) + kTf32Round) & kTf32Mask" in TC


def test_tf32_model_rounds_to_nearest_half_away_from_zero():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(20000) * 2.0 ** rng.integers(-30, 30, 20000)
         ).astype(np.float32)
    bits = x.view(np.uint32)
    ties = ((bits & np.uint32(MASK)) | np.uint32(HALF)).view(np.float32)
    x = np.concatenate([x, ties, np.float32([0.0, -0.0, 1.0, 2 ** 24 - 1])])
    hi = tf32(x)
    assert not (hi.view(np.uint32) & ~np.uint32(MASK)).any()
    x64, hi64 = x.astype(np.float64), hi.astype(np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(np.where(x64 == 0, 1, x64)))) - 10)
    err = np.abs(x64 - hi64)
    assert (err <= ulp / 2).all()
    at_tie = err == ulp / 2
    assert at_tie.sum() >= 20000 - 10
    assert (np.abs(hi64[at_tie]) > np.abs(x64[at_tie])).all()
    nz = x64 != 0
    assert (err[nz] <= 2.0 ** -11 * np.abs(x64[nz])).all()


def test_integers_below_2_22_split_exactly_into_two_pieces():
    rng = np.random.default_rng(1)
    a = np.concatenate([rng.integers(-(1 << 22) + 1, 1 << 22, 200000),
                        np.arange(-4100, 4100), [(1 << 22) - 1, -(1 << 22) + 1,
                                                 4095 * 1024, 16383 * 121]])
    hi, lo = split(a.astype(np.float32))
    assert (hi.astype(np.int64) + lo.astype(np.int64) == a).all()


def test_integers_below_2_24_leave_at_most_one_and_three_pieces_are_exact():
    rng = np.random.default_rng(2)
    a = np.concatenate([rng.integers(-(1 << 24) + 1, 1 << 24, 200000),
                        [16383 * 1024, -16383 * 1000, (1 << 24) - 1,
                         (1 << 22) + 1, 4097 * 1024]])
    a32 = a.astype(np.float32)
    assert (a32.astype(np.int64) == a).all()
    hi, lo = split(a32)
    res = a - hi.astype(np.int64) - lo.astype(np.int64)
    assert np.abs(res).max() == 1
    assert (np.abs(res) <= RESIDUAL * np.abs(a)).all()
    third = tf32(res.astype(np.float32))
    assert (hi.astype(np.int64) + lo.astype(np.int64)
            + third.astype(np.int64) == a).all()


OPERATORS = [(8, 2, "DCT"), (8, 1, "DCT"), (8, 4, "DCT"), (8, 5, "DCT"),
             (24, 4, "DCT"), (8, 4, "DFT"), (8, 3, "DFT"), (3, 2, "DCT"),
             (4, 1, "DFT")]


@pytest.mark.parametrize("d,bs,tr", OPERATORS)
def test_operator_pieces_sum_back_within_the_stated_residual(d, bs, tr):
    op = T.combined_decode_operator(d, bs, tr).T.astype(np.float32)
    hi, lo = split(op)
    res = op.astype(np.float64) - hi.astype(np.float64) - lo.astype(np.float64)
    assert (np.abs(res) <= RESIDUAL * np.abs(op.astype(np.float64))).all()
    assert (np.abs(op.astype(np.float64) - hi) <= 2.0 ** -11 * np.abs(op)).all()


def test_error_bound_of_the_split_is_inside_the_contract():
    assert bound_factor(64) == pytest.approx(20.1, abs=0.05)
    assert bound_factor(576) == pytest.approx(52.8, abs=0.05)
    for K_ in range(1, 8193):
        assert bound_factor(K_) < K_ + 16, K_


def _trunc32(x):
    """f64 -> f32 rounding toward zero (the tensor cores' assumed sum)."""
    t = x.astype(np.float32)
    over = np.abs(t.astype(np.float64)) > np.abs(x)
    t[over] = np.nextafter(t[over], np.float32(0))
    return t


def model_sums(a32, b32):
    """The kernel's f32 sums of a32 (N, K) @ b32 (K, M): per k8 step
    d = a_hi b_hi + (a_hi b_lo + (a_lo b_hi + 0)), each product sum truncated
    to f32, then acc += d rounded to nearest in f32."""
    ah, al = (p.astype(np.float64) for p in split(a32))
    bh, bl = (p.astype(np.float64) for p in split(b32))
    acc = np.zeros((a32.shape[0], b32.shape[1]), np.float32)
    for k0 in range(0, a32.shape[1], 8):
        s = slice(k0, k0 + 8)
        d = _trunc32(al[:, s] @ bh[s])
        d = _trunc32(ah[:, s] @ bl[s] + d)
        d = _trunc32(ah[:, s] @ bh[s] + d)
        acc = acc + d
    return acc


def model_decode_blocks(levels, op_t, deq, bs=1):
    a32 = (levels.to(torch.int32) * deq).to(torch.float32).numpy()
    acc = model_sums(a32, op_t.numpy())
    pix = torch.from_numpy(np.clip(np.rint(acc), 0, 255).astype(np.uint8))
    return K.inflate_blocks(pix, bs)


@pytest.mark.parametrize("d,bs,tr,deq_value,hi", [
    (8, 2, "DCT", None, 300), (8, 4, "DFT", None, 300),
    (24, 4, "DCT", 1000, 40), (8, 2, "DCT", 1024, 4095),
    (8, 2, "DCT", 1024, 16383), (24, 1, "DCT", 1024, 16383),
    (3, 1, "DCT", 7, 1000)])
def test_model_product_within_the_stated_bound(d, bs, tr, deq_value, hi):
    rng = np.random.default_rng(d * bs + hi)
    L = d * d
    op_t = T.combined_decode_operator(d, bs, tr).T.astype(np.float32)
    lv = np.where(rng.random((96, L)) < 0.4,
                  rng.integers(-hi, hi + 1, (96, L)), 0)
    deq = (np.full(L, deq_value) if deq_value else
           rng.integers(1, 122, L))
    a32 = (lv * deq).astype(np.float32)
    exact = a32.astype(np.float64) @ op_t.astype(np.float64)
    terms = np.abs(a32.astype(np.float64)) @ np.abs(op_t.astype(np.float64))
    err = np.abs(model_sums(a32, op_t).astype(np.float64) - exact)
    assert (err <= bound_factor(L) * EPS32 * terms + 1e-300).all()


TIE_CASES = {   # the main path, bs 4 / 5, d 24 and the DFT, at small size
    "main_bs2_qtable": (32, 48, 2, 8, "DCT", "qtable", {}),
    "bs4_none": (40, 56, 4, 8, "DCT", "none", {}),
    "bs5_qtable": (46, 61, 5, 8, "DCT", "qtable", {}),
    "d24_divide1000": (30, 50, 4, 24, "DCT", "divide", {"divisor": 1000}),
    "dft_bs4_qtable": (32, 48, 4, 8, "DFT", "qtable", {}),
    "dft_bs3_none": (23, 37, 3, 8, "DFT", "none", {}),
}


@pytest.mark.parametrize("name", sorted(TIE_CASES))
def test_model_product_holds_the_tie_contract_against_jpeg_tpu(
        name, monkeypatch):
    h, w, bs, d, tr, qn, qp = TIE_CASES[name]
    kw = dict(width=w, height=h, block_size=bs, dct_size=d, transform=tr)
    tcfg = Configuration(**kw, quantization=QuantizationMethod(qn, **qp))
    jcfg = JConfiguration(**kw, quantization=JQuantizationMethod(qn, **qp))
    L = d * d
    rng = np.random.default_rng(h * w + bs)
    lv = np.where(rng.random((3, tcfg.num_blocks, L)) < 0.3,
                  rng.integers(-30, 31, (3, tcfg.num_blocks, L)), 0)
    lv[:, :, 0] = rng.integers(-60, 61, (3, tcfg.num_blocks))
    lv = lv.astype(np.int32)
    dec = BandDecoder(tcfg)
    assert dec.branch == "kernel"
    monkeypatch.setattr(K, "decode_blocks", model_decode_blocks)
    got = dec(torch.from_numpy(lv)).numpy()
    f = jband.make_decode(jband.config_key(jcfg), "float32", False)
    for b in range(3):
        want = np.asarray(f(jnp.asarray(lv[b])))
        ref, ties = jparity.decode_reference_and_ties(jcfg, lv[b])
        jparity.assert_tie_equal(got[b], want, ties, f"{name} band {b}")
        jparity.assert_tie_equal(got[b], ref, ties, f"{name} f64 band {b}")


def test_decode_blocks_sums_on_the_cpu_is_the_full_f32_product():
    rng = np.random.default_rng(3)
    lv = torch.from_numpy(rng.integers(-50, 51, (70, 64)).astype(np.int32))
    op_t = torch.from_numpy(np.ascontiguousarray(
        T.combined_decode_operator(8, 2, "DCT").T, np.float32))
    deq = torch.from_numpy(rng.integers(1, 100, 64).astype(np.int32))
    sums = K.decode_blocks_sums(lv, op_t, deq)
    assert sums.dtype == torch.float32 and sums.shape == (70, 256)
    np.testing.assert_array_equal(
        torch.round(sums).clamp(0, 255).to(torch.uint8).numpy(),
        K.decode_blocks_plain(lv, op_t, deq).numpy())
    with pytest.raises(ValueError, match="op_t"):
        K.decode_blocks_sums(lv, op_t[:63].contiguous(), deq)
    before = K.decode_blocks.launches
    K.decode_blocks_sums(lv, op_t, deq)
    assert K.decode_blocks.launches == before


# ---------------------------------------------------------------------------
# K4: the tile plan and the inflate store
# ---------------------------------------------------------------------------

DEC4 = _source("decode_blocks.cu")
SHAPES4 = {name: tuple(int(v or 32) for v in re.search(
    rf"using {name} = Shape<(\d+), (\d+)(?:, (\d+))?>;", TC).groups())
    for name in ("Wide", "W96", "Tall")}
# The byte permutes of the 16-byte store: selectors of bs 4 (one word of 4
# pixels) and bs 2 (two words of 8).
PERM4 = [int(v, 16) for v in re.findall(r"__byte_perm\(w, 0, (0x[0-9a-f]{4})\)",
                                        DEC4)]
PERM2 = [(w, int(v, 16)) for w, v in re.findall(
    r"__byte_perm\(w\.([xy]), 0, (0x[0-9a-f]{4})\)", DEC4)]


def k4_step(name, M, d, bs):
    """``step_of<S>``: whole d-pixel rows where bs > 1 and a row fits."""
    BN = SHAPES4[name][1]
    if bs > 1 and d <= BN:
        return M if M <= BN else BN // d * d
    return BN


def k4_plan(M, bs):
    """``launch``: the shape that computes the fewest columns (the wide
    tile first, then the 96-wide, then the tall one), its step, and whether
    the store takes 16-byte chunks (whole rows, bs 2 or 4, d * bs a
    multiple of 16; the output is 16-byte aligned)."""
    d = math.isqrt(M) if bs > 1 else 0
    cost = {name: -(-M // k4_step(name, M, d, bs)) * SHAPES4[name][1]
            for name in ("Wide", "W96", "Tall")}
    name = min(cost, key=lambda k: (cost[k], list(cost).index(k)))
    step = k4_step(name, M, d, bs)
    chunks = (bs > 1 and step % d == 0 and bs in (2, 4)
              and d * bs % 16 == 0)
    return name, step, chunks


def _perm(words, sel):
    """``__byte_perm(x, y, sel)`` on little-endian bytes: byte i of the
    result is byte (sel >> 4 i) & 7 of (x, y)."""
    return [words[(sel >> (4 * i)) & 7] for i in range(4)]


def model_inflate_store(pix, bs):
    """K4's tiles and store over (N, M) staged pixels, in numpy: each tile
    stages its rows' columns [col0, col0 + BN) (zeros past M), then writes
    its part of every block, as 16-byte chunks of permuted pixels or pixel
    by pixel.  Returns the output and how often each byte was written."""
    n, M = pix.shape
    name, step, chunks = k4_plan(M, bs)
    BM, BN, _ = SHAPES4[name]
    d = math.isqrt(M)
    W, blk = d * bs, M * bs * bs
    out = np.zeros(n * blk, np.uint8)
    writes = np.zeros(n * blk, np.int64)
    padded = np.zeros((-(-n // BM) * BM, M + BN), np.uint8)
    padded[:n, :M] = pix
    for row0 in range(0, n, BM):
        for col0 in range(0, M, step):
            os_ = padded[row0:row0 + BM, col0:col0 + BN]
            cols = min(step, M - col0)
            if chunks:
                row_chunks = W // 16
                per = cols // d * bs * row_chunks
                px = 16 // bs
                c = np.arange(BM * per)
                r, k = c // per, c % per
                keep = row0 + r < n
                r, k = r[keep], k[keep]
                R = k // row_chunks
                src = (R // bs) * d + (k - R * row_chunks) * px
                got = os_[r[:, None], src[:, None] + np.arange(px)]
                if bs == 4:
                    chunk = np.concatenate(
                        [np.stack(_perm(got.T, sel), 1) for sel in PERM4], 1)
                else:
                    half = {"x": got[:, :4].T, "y": got[:, 4:].T}
                    chunk = np.concatenate(
                        [np.stack(_perm(half[w], sel), 1)
                         for w, sel in PERM2], 1)
                at = ((row0 + r) * blk + col0 * bs * bs + k * 16)[:, None] \
                    + np.arange(16)
            else:
                e = np.arange(BM * cols)
                r, c = e // cols, e % cols
                keep = row0 + r < n
                r, c = r[keep], c[keep]
                j = col0 + c
                p, q = j // d, j % d
                base = (row0 + r) * blk + p * bs * W + q * bs
                at = (base[:, None] + (np.arange(bs)[:, None] * W
                                       + np.arange(bs)).ravel())
                chunk = np.repeat(os_[r, c][:, None], bs * bs, 1)
            out[at.ravel()] = chunk.ravel()
            np.add.at(writes, at.ravel(), 1)
    return out.reshape(n, blk), writes


def test_k4_plan_covers_the_cells_rows_without_waste():
    """At d 24 the 96-wide tile takes six tiles of four 24-pixel rows, at
    d 8 the tall one the whole block, both with 16-byte chunks at bs 2 and
    4; at bs 1 the product at the combined operator's width keeps the wide
    tile; the source names the three shapes and the choice."""
    assert SHAPES4 == {"Wide": (64, 128, 32), "W96": (64, 96, 24),
                       "Tall": (128, 64, 32)}
    assert k4_plan(576, 4) == k4_plan(576, 2) == ("W96", 96, True)
    assert k4_plan(64, 4) == k4_plan(64, 2) == ("Tall", 64, True)
    assert k4_plan(9216, 1) == ("Wide", 128, False)
    assert k4_plan(1024, 1) == ("Wide", 128, False)
    assert k4_plan(576, 1) == ("W96", 96, False)
    assert k4_plan(64, 1) == ("Tall", 64, False)
    assert k4_plan(576, 3)[:2] == ("W96", 96) and not k4_plan(576, 3)[2]
    assert "if (wide <= w96 && wide <= tall)" in DEC4
    assert "if (w96 <= tall)" in DEC4
    assert PERM4 == [0x0000, 0x1111, 0x2222, 0x3333]
    assert PERM2 == [("x", 0x1100), ("x", 0x3322), ("y", 0x1100),
                     ("y", 0x3322)]
    # the 96-wide tile's B fragment loads: g (8) x t (4) lanes in 32 banks
    b_stride = SHAPES4["W96"][1] + 8
    assert len({(g + t * b_stride) % 32 for g in range(8)
                for t in range(4)}) == 32


@pytest.mark.parametrize("d,bs", [
    (8, 4), (24, 4), (24, 2), (8, 2), (32, 2), (6, 4), (3, 3), (5, 2),
    (12, 4), (16, 2), (24, 3), (2, 4), (4, 4), (40, 2), (130, 2)])
@pytest.mark.parametrize("n", [1, 63, 65, 130])
def test_k4_store_model_writes_each_byte_once_as_the_inflate(d, bs, n):
    """Every byte of the (N, (d*bs)**2) output is written exactly once, and
    the output is :func:`inflate_blocks` of the pixels, whichever store
    the plan takes (chunks of whole rows, or pixel by pixel where a row is
    split, bs is 3 or d * bs is not a multiple of 16)."""
    M = d * d
    pix = np.random.default_rng(d * 100 + bs + n).integers(
        0, 256, (n, M), dtype=np.uint8)
    out, writes = model_inflate_store(pix, bs)
    assert (writes == 1).all()
    np.testing.assert_array_equal(
        out, K.inflate_blocks(torch.from_numpy(pix), bs).numpy())


# ---------------------------------------------------------------------------
# K2: the fused deposit
# ---------------------------------------------------------------------------

TILE = int(re.search(r"constexpr int kTileBlocks = (\d+);", COMPACT)[1])
THREADS = TILE if "constexpr int kThreads = kTileBlocks;" in COMPACT else 0
PREFIX = 1 << int(re.search(r"kPrefixFlag = 1ull << (\d+);", COMPACT)[1])
FULL = 0xffffffff


def test_tile_and_flag_constants_match_the_wrapper():
    assert TILE == K.DEPOSIT_TILE_BLOCKS == 256
    assert THREADS == TILE
    assert PREFIX == 1 << 62


class _Tile:
    """csrc/compact.cu's Tile: the tile's rows (uint32) and offsets."""

    def __init__(self, rows, off, W):
        self.rows, self.off, self.W = rows, off, W

    def block_of(self, p):
        lo, hi = 0, len(self.off) - 2
        while lo < hi:
            mid = (lo + hi + 1) >> 1
            if self.off[mid] <= p:
                lo = mid
            else:
                hi = mid - 1
        return lo

    def row_word(self, j, wi):
        return int(self.rows[j, wi]) if wi < self.W else 0

    def byte_at(self, p):
        j = self.block_of(p)
        q = p - self.off[j]
        return (self.row_word(j, q >> 2) >> (24 - 8 * (q & 3))) & 0xff

    def word_at(self, p):
        j = self.block_of(p)
        q = p - self.off[j]
        word = have = 0
        while True:
            left = self.off[j + 1] - self.off[j] - q
            take = min(left, 4 - have)
            if take > 0:
                sh = 8 * (q & 3)
                hi = self.row_word(j, q >> 2)
                lo = self.row_word(j, (q >> 2) + 1) if sh else 0
                v = ((hi << sh) | (lo >> (32 - sh))) & FULL if sh else hi
                keep = FULL if take == 4 else ~(FULL >> (8 * take)) & FULL
                word |= (v & keep) >> (8 * have)
                have += take
            if have == 4 or j + 1 >= len(self.off) - 1:
                return word
            j += 1
            q = 0


def _look_back(status, tile, window=THREADS):
    """The thread block's look-back: ``window`` predecessors a round (one a
    thread), up to the nearest published prefix (or the start)."""
    base, j = 0, tile - 1
    while True:
        s = [status[j - k] if j - k >= 0 else PREFIX for k in range(window)]
        pref = [k for k in range(window) if s[k] & PREFIX]
        stop = pref[0] if pref else window
        base += sum(v & (PREFIX - 1) for v in s[:stop + 1])
        if pref:
            return base
        j -= window


def deposit_model(rows, blk_bytes, cap, tile_blocks, order, window=THREADS):
    """The buffer and each byte's writer count, the tiles run in ``order``
    (any order is legal), looking back ``window`` tiles a round."""
    n, W = rows.shape
    rows = rows.view(np.uint32)
    tiles = -(-n // tile_blocks)
    status = [int(blk_bytes[t * tile_blocks:(t + 1) * tile_blocks].sum())
              for t in range(tiles)]                                 # launch 1
    out = np.zeros(cap, np.uint8)
    writes = np.zeros(cap, np.int64)

    def put(p, byte):
        out[p] = byte
        writes[p] += 1

    for t in order:                                                  # launch 2
        first = t * tile_blocks
        bb = np.zeros(tile_blocks, np.int64)
        part = blk_bytes[first:first + tile_blocks]
        bb[:len(part)] = part
        off = [0] + np.cumsum(bb).tolist()      # the block scan
        total = off[-1]
        base = _look_back(status, t, window)
        status[t] = PREFIX | (base + total)
        tr = np.zeros((tile_blocks, W), np.uint32)
        tr[:len(part)] = rows[first:first + len(part)]
        tl = _Tile(tr, off, W)
        end = min(base + total, cap)
        if base < end:
            wa, wb = (base + 3) >> 2, end >> 2
            if wa < wb:
                for w in range(wa, wb):
                    word = tl.word_at(4 * w - base)
                    for i in range(4):
                        put(4 * w + i, (word >> (24 - 8 * i)) & 0xff)
                for p in range(base, 4 * wa):
                    put(p, tl.byte_at(p - base))
                for p in range(4 * wb, end):
                    put(p, tl.byte_at(p - base))
            else:
                for p in range(base, end):
                    put(p, tl.byte_at(p - base))
        if t == tiles - 1 and base + total < cap:
            for p in range(base + total, cap):
                put(p, 0)
    return out, writes


def _rows_and_bytes(rng, n, W):
    rows = rng.integers(-2 ** 31, 2 ** 31, (n, W)).astype(np.int32)
    bb = rng.integers(1, 4 * W + 1, n)
    bb[rng.random(n) < 0.2] = 1                      # EOB-only blocks
    bb[rng.random(n) < 0.2] = 4 * W                  # rows filled exactly
    return rows, bb.astype(np.int32)


@pytest.mark.parametrize("tile_blocks", [TILE, 8])
@pytest.mark.parametrize("n,W", [(1, 1), (3, 2), (300, 4), (601, 3)])
def test_deposit_model_equals_the_plain_version(n, W, tile_blocks):
    rng = np.random.default_rng(n * 7 + W + tile_blocks)
    rows, bb = _rows_and_bytes(rng, n, W)
    total = int(bb.astype(np.int64).sum())
    tiles = -(-n // tile_blocks)
    orders = [list(range(tiles)), list(range(tiles))[::-1],
              rng.permutation(tiles).tolist()]
    for cap in sorted({total, total - 1, max(total - 5, 0), total // 2, 1, 2,
                       total + 1, total + 3, total + 7}):
        want = K.deposit_rows_plain(torch.from_numpy(rows),
                                    torch.from_numpy(bb), cap).numpy()
        for order in orders:
            got, writes = deposit_model(rows, bb, cap, tile_blocks, order,
                                        window=min(tile_blocks, 16))
            assert (writes == 1).all(), (cap, order[:5])
            np.testing.assert_array_equal(got, want, err_msg=f"cap {cap}")


def test_deposit_model_on_encoder_rows_is_the_host_stream():
    """Rows and block bytes from K1's plain version over levels with
    EOB-only, dense and chained blocks: the model's buffer is the numpy
    encoder's stream."""
    rng = np.random.default_rng(9)
    lv = np.where(rng.random((517, 64)) < 0.2,
                  rng.integers(-900, 901, (517, 64)), 0)
    lv[::5] = 0
    lv[1::9, 63] = 16383
    lv = lv.astype(np.int32)
    bb_max = int(K.encode_stream_rows_plain(torch.from_numpy(lv), 64)[1].max())
    W = -(-bb_max // 4)
    rows, bb = K.encode_stream_rows_plain(torch.from_numpy(lv), W)
    total = int(bb.sum())
    got, writes = deposit_model(rows.numpy(), bb.numpy(), total, 8,
                                rng.permutation(65).tolist())
    assert (writes == 1).all()
    assert got.tobytes() == NC.encode_levels(lv)
