"""The Hopper design of K1 (``encode_stream_rows``: levels -> rows) and K9
(``encode_stream_rows_tables``: unit-group tables -> rows), modelled in
numpy against their plain versions and jpeg_tpu.

The CUDA kernels run only on a GPU, where chip_smoke.py holds them against
their plain versions at the same edges.  Here:

* a model of the lane-parallel writer of ``csrc/bit_writer.cuh``: lane k
  of a block's group of G lanes owns slots [k m, (k + 1) m), m = ceil(S /
  G); K1's lanes find their nonzeros, an inclusive max-scan of "last
  nonzero" gives each lane the last nonzero before its slots (so the zero
  run, and its 0xF0 chain bytes, of its first nonzero), a sum-scan of the
  lanes' bit counts gives each its first bit; each lane then writes its
  words from that bit's phase, storing the words inside its range and
  OR-ing the ones it shares with a neighbour into a zeroed row, dropping
  the words past W.  The model checks that no stored word is touched by
  another lane, and its rows and block bytes equal
  ``encode_stream_rows_plain`` at L = 9, 16, 64, 144 and 576, G = 1 ...
  32 and the plan's, W exact, truncated (W - 1, W - 3) and wider, on the
  edge levels chip_smoke.py uses (all-zero and all-+-16383 blocks, a
  nonzero only at slot 0 and L - 1, at every lane's first or last slot,
  runs of 15 k and 15 k +- 1 zeros across a lane boundary, adversarial
  levels);
* the same model against jpeg_tpu's Pallas ``encode_stream_rows_lv`` run
  in interpret mode (``PK.ENC_TILE`` cut to 64): its natural-layout branch
  at L = 16 and 64, its transposed branch (``nat=False``) at L = 144 (L >
  ``ENC_NAT_MAX_L``, with its extra chain appends past 75) and, with
  ``ENC_NAT_MAX_L`` patched to 8, at L = 16; at L = 576, where its slot
  loop is unrolled about ten times a level and out of a test's reach,
  against jpeg_tpu's host encoder;
* K9's model against ``encode_stream_rows_tables_plain``, against K1's
  rows and against jpeg_tpu's interpret-mode tables ``encode_stream_rows``;
* ``encode_rows_plan`` against the constants read from the sources (lanes,
  slots per lane, threads, the shared-row budget, the switch to the
  global row, the most shared memory) and the launch's own checks.

Everything is bit manipulation, so every comparison is exact.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jpeg_tpu.entropy as jentropy
from jpeg_tpu.entropy import device_codec as JDC
from jpeg_tpu.ops import pallas_kernels as PK

from jpeg_tpu_torch.entropy import device_codec as DC
from jpeg_tpu_torch.ops import kernels as K

torch.set_num_threads(2)

CSRC = os.path.join(os.path.dirname(K.__file__), os.pardir, "csrc")


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


BW = _source("bit_writer.cuh")
K1_SRC = _source("encode_stream.cu")
K9_SRC = _source("encode_tables.cu")


def _const(src, name):
    m = re.search(rf"constexpr int {name} = (\d+)(?: << (\d+))?;", src)
    return int(m[1]) << int(m[2] or 0)


MASK32 = (1 << 32) - 1
LANES = K.ENC_LANES            # group sizes with a kernel: 1, 4, ..., 32
SMS = 132                     # an H100 SXM's multiprocessors


# ---------------------------------------------------------------------------
# The model of csrc/bit_writer.cuh's lane writer
# ---------------------------------------------------------------------------

class _Row:
    """A zeroed row of W words; records which lane stored or OR'd each
    word, and drops words past W (counted by the writer, not stored)."""

    def __init__(self, W):
        self.words = [0] * W
        self.stored = {}          # word -> the lane that stored it
        self.ored = {}            # word -> the lanes that OR'd into it

    def put(self, wi, w, shared, lane):
        if wi >= len(self.words):
            return
        if shared:
            self.ored.setdefault(wi, set()).add(lane)
            self.words[wi] |= w
        else:
            assert wi not in self.stored, f"word {wi} stored twice"
            self.stored[wi] = lane
            self.words[wi] = w

    def check_lanes_disjoint(self):
        """A stored word belongs to its lane alone (many short ranges may
        share an OR'd one)."""
        for wi, lane in self.stored.items():
            assert self.ored.get(wi, set()) <= {lane}, (wi, lane)


class _LaneWriter:
    """``jt::LaneWriter``: bits from ``bit0`` on, MSB first, through a
    64-bit accumulator started at the bit's phase in its word."""

    def __init__(self, row, lane, bit0):
        self.row, self.lane = row, lane
        self.wi = self.first = bit0 >> 5
        self.first_shared = (bit0 & 31) != 0
        self.nacc = bit0 & 31
        self.acc = 0

    def append(self, nbits, val):
        assert 0 <= nbits <= 32 and val >> nbits == 0
        self.acc = (self.acc << nbits) | val
        assert self.acc < 1 << 64
        self.nacc += nbits
        if self.nacc >= 32:
            self.nacc -= 32
            self.row.put(self.wi, (self.acc >> self.nacc) & MASK32,
                         self.first_shared and self.wi == self.first,
                         self.lane)
            self.wi += 1
            self.acc &= (1 << self.nacc) - 1

    def finish(self):
        if self.nacc > 0 and self.acc != 0:
            self.row.put(self.wi, (self.acc << (32 - self.nacc)) & MASK32,
                         True, self.lane)
            self.wi += 1


def _lane_slots(S, G):
    m = -(-S // G)
    return [(min(k * m, S), min(min(k * m, S) + m, S)) for k in range(G)]


def _size(a):
    return min(abs(a).bit_length() + 1, K.MAX_SIZE)


def model_k1_block(lv, G, W):
    """One block's row and byte count, as K1's group of G lanes writes
    them."""
    L = len(lv)
    slots = _lane_slots(L, G)
    # Pass 1: each lane's nonzeros, first and last, and bits but for its
    # first nonzero's zero run.
    last, first, bits = [], [], []
    for s0, s1 in slots:
        nz = [s for s in range(s0, s1) if lv[s] != 0]
        b = sum(8 * ((s - p - 1) // K.MAX_RUN) + 8 + _size(lv[s])
                for p, s in zip(nz, nz[1:]))
        first.append(nz[0] if nz else -1)
        last.append(nz[-1] if nz else -1)
        bits.append(b)
    incl_max = np.maximum.accumulate(last).tolist()
    prev = [-1] + incl_max[:-1]                  # the max-scan, exclusive
    for k in range(G):
        if first[k] >= 0:
            bits[k] += (8 * ((first[k] - prev[k] - 1) // K.MAX_RUN) + 8
                        + _size(lv[first[k]]))
    incl = np.cumsum(bits).tolist()              # the sum-scan
    total = incl[-1]
    # Pass 2: each lane deposits from its first bit.
    row = _Row(W)
    for k, (s0, s1) in enumerate(slots):
        if bits[k] == 0:
            continue
        lw = _LaneWriter(row, k, incl[k] - bits[k])
        p = prev[k]
        for s in range(s0, s1):
            a = int(lv[s])
            if a == 0:
                continue
            size = _size(a)
            run = s - p - 1
            nch, rrem = divmod(run, K.MAX_RUN)
            while nch >= 4:
                lw.append(32, 0xF0F0F0F0)
                nch -= 4
            if nch:
                lw.append(8 * nch, 0xF0F0F0F0 >> (32 - 8 * nch))
            mag = abs(a) & ((1 << (size - 1)) - 1)
            lw.append(8 + size, (rrem << (4 + size)) | (size << size)
                      | (int(a > 0) << (size - 1)) | mag)
            p = s
        lw.finish()
    row.check_lanes_disjoint()
    return row.words, (total + 8 + 7) >> 3


def model_k9_block(cb, vhi, vlo, G, W):
    """One block's row as K9's group of G lanes writes it."""
    slots = _lane_slots(len(cb), G)
    clamp = [min(max(int(c), 0), 64) for c in cb]
    bits = [sum(clamp[s0:s1]) for s0, s1 in slots]
    incl = np.cumsum(bits).tolist()
    row = _Row(W)
    for k, (s0, s1) in enumerate(slots):
        if bits[k] == 0:
            continue
        lw = _LaneWriter(row, k, incl[k] - bits[k])
        for s in range(s0, s1):
            c = clamp[s]
            if c == 0:
                continue
            lo = int(vlo[s]) & MASK32
            if c > 32:
                lw.append(c - 32, int(vhi[s]) & MASK32 & ((1 << (c - 32)) - 1))
                lw.append(32, lo)
            else:
                lw.append(c, lo & ((1 << c) - 1))
        lw.finish()
    row.check_lanes_disjoint()
    return row.words


def _i32(words):
    return np.asarray(words, np.int64).astype(np.uint32).view(np.int32)


def model_k1(levels, G, W):
    out = [model_k1_block(list(map(int, b)), G, W) for b in levels]
    return (_i32([r for r, _ in out]).reshape(len(out), W),
            np.array([n for _, n in out], np.int32))


def model_k9(cbits, vhi, vlo, G, W):
    return _i32([model_k9_block(c, h, lo, G, W)
                 for c, h, lo in zip(cbits, vhi, vlo)]).reshape(len(cbits), W)


# ---------------------------------------------------------------------------
# The edge levels (chip_smoke.py's K1/K9 edges)
# ---------------------------------------------------------------------------

def edge_levels(L, G, seed):
    """Blocks at the writer's edges for groups of G lanes: all zero, all
    +-16383, a nonzero only at slot 0 and L - 1, one at every lane's first
    slot and one at every lane's last, runs of 15 k and 15 k +- 1 zeros
    ending one slot past a lane boundary, and sparse random levels."""
    rng = np.random.default_rng(seed)
    m = -(-L // G)
    firsts = list(range(0, L, m))
    lasts = [min(s + m, L) - 1 for s in firsts]
    rows = [np.zeros(L, np.int64),
            rng.choice([-16383, 16383], L)]
    for cols in ([0, L - 1], firsts, lasts):
        r = np.zeros(L, np.int64)
        r[cols] = rng.choice([-16383, -1, 1, 255, 16383], len(cols))
        rows.append(r)
    for k in sorted({1, 2, 4, 5, L // 15}):
        for run in (15 * k - 1, 15 * k, 15 * k + 1):
            for b in firsts[1:2] + firsts[-1:]:
                if 0 <= run <= b:
                    r = np.zeros(L, np.int64)
                    r[b] = rng.integers(1, 16384)
                    if b - run - 1 >= 0:
                        r[b - run - 1] = -rng.integers(1, 16384)
                    rows.append(r)
    for _ in range(6):
        rows.append(np.where(rng.random(L) < rng.choice([0.05, 0.3, 0.9]),
                             rng.integers(-16383, 16384, L), 0))
    return np.stack(rows).astype(np.int32)


def _width(levels):
    return -(-int(DC.block_bytes_of(torch.from_numpy(levels)).max()) // 4)


# ---------------------------------------------------------------------------
# K1: the model vs the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", [9, 16, 64, 144, 576])
def test_k1_model_equals_plain(L):
    """Every group size and the plan's, W exact, truncated and wider: the
    model's rows and block bytes equal the plain version's (one plain call
    on every group size's edge levels, cut to each width: a narrower row
    keeps the wider one's first words)."""
    groups = LANES
    sets = [edge_levels(L, G, seed=L + G) for G in groups]
    W = max(_width(lv) for lv in sets)
    rows_p, bb_p = K.encode_stream_rows_plain(
        torch.from_numpy(np.concatenate(sets)), W + 5)
    i = 0
    for G, lv in zip(groups, sets):
        want_rows = rows_p.numpy()[i:i + len(lv)]
        want_bb = bb_p.numpy()[i:i + len(lv)]
        i += len(lv)
        Wg = _width(lv)
        for w in sorted({Wg, max(Wg - 1, 1), max(Wg - 3, 1), Wg + 5}):
            rows_m, bb_m = model_k1(lv, G, w)
            np.testing.assert_array_equal(rows_m, want_rows[:, :w],
                                          err_msg=f"G={G} W={w}")
            np.testing.assert_array_equal(bb_m, want_bb)


def test_k1_model_zero_run_crosses_every_lane():
    """A run from slot 0 to slot L - 1 crosses every lane: only the last
    lane writes (its 38 chain bytes at L = 576), the others nothing."""
    L = 576
    lv = np.zeros((2, L), np.int32)
    lv[0, L - 1] = 7
    lv[1, 0], lv[1, L - 1] = -3, 16383
    rows_p, bb_p = K.encode_stream_rows_plain(torch.from_numpy(lv), 16)
    rows_m, bb_m = model_k1(lv, 32, 16)
    np.testing.assert_array_equal(rows_m, rows_p.numpy())
    np.testing.assert_array_equal(bb_m, bb_p.numpy())
    assert bb_m[0] == (8 * 38 + 8 + 4 + 8 + 7) // 8


def test_k1_model_equals_host_encoder_at_576():
    """At L = 576 the rows, cut at the block bytes, are jpeg_tpu's host
    encoder's stream (jpeg_tpu's interpret-mode kernel is out of reach
    there: its slot loop is unrolled ten times per level)."""
    lv = edge_levels(576, 32, seed=3)
    W = _width(lv)
    rows, bb = model_k1(lv, 32, W)
    raw = rows.view(np.uint32).byteswap().view(np.uint8).reshape(len(lv), -1)
    got = b"".join(raw[i, :bb[i]].tobytes() for i in range(len(lv)))
    assert got == jentropy.encode_levels(lv)


# ---------------------------------------------------------------------------
# K1: the model vs jpeg_tpu's interpret-mode Pallas kernel
# ---------------------------------------------------------------------------

def _pallas_k1(monkeypatch, lv, W):
    monkeypatch.setenv("JPEG_TPU_PALLAS", "interpret")
    monkeypatch.setattr(PK, "ENC_TILE", 64)
    rows, bb = PK.encode_stream_rows_lv(jnp.asarray(lv), W, interpret=True)
    return np.asarray(rows), np.asarray(bb)


def _pallas_case(L, seed, n=64):
    """n blocks: the edge levels (for a warp a block), topped up with
    sparse random ones."""
    lv = edge_levels(L, 32, seed)[:n]
    rng = np.random.default_rng(seed)
    extra = np.where(rng.random((n - len(lv), L)) < 0.2,
                     rng.integers(-16383, 16384, (n - len(lv), L)), 0)
    return np.concatenate([lv, extra]).astype(np.int32)


@pytest.mark.parametrize("L,nat_max", [(16, None), (64, None), (144, None),
                                       (16, 8)])
def test_k1_model_equals_pallas_interpret(monkeypatch, L, nat_max):
    """jpeg_tpu's K1 in interpret mode: the natural layout at L <= 128,
    ``nat=False`` past it (L = 144) and, with ENC_NAT_MAX_L patched, at
    L = 16; W exact and one word short.  A block longer than 4 W bytes
    keeps its first 4 W bytes here and its last ones there (both callers
    raise on it): its bytes are compared, its row is not."""
    if nat_max is not None:
        monkeypatch.setattr(PK, "ENC_NAT_MAX_L", nat_max)
    lv = _pallas_case(L, seed=L)
    W = _width(lv)
    widths = (W,) if L > 64 else (W, W - 1)
    for w in widths:
        want_rows, want_bb = _pallas_k1(monkeypatch, lv, w)
        G = K.encode_rows_plan(len(lv), L, w, SMS).lanes
        rows_m, bb_m = model_k1(lv, G, w)
        np.testing.assert_array_equal(bb_m, want_bb)
        fits = bb_m <= 4 * w
        assert fits.sum() >= len(lv) - 2
        np.testing.assert_array_equal(rows_m[fits], want_rows[fits],
                                      err_msg=f"W={w}")


# ---------------------------------------------------------------------------
# K9: the model vs the plain version, K1's rows and jpeg_tpu's kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", [9, 16, 64])
def test_k9_model_equals_plain_and_k1(L):
    """K9's model on ``_unit_groups``' tables: its rows equal the plain
    version's and K1's model's, for every group size, W exact and
    truncated."""
    for G in LANES:
        lv = edge_levels(L, G, seed=2 * L + G)
        cbits, vhi, vlo, _ = DC._unit_groups(torch.from_numpy(lv))
        W = _width(lv)
        for w in sorted({W, max(W - 1, 1), max(W - 3, 1)}):
            want = K.encode_stream_rows_tables_plain(cbits, vhi, vlo, w)
            got = model_k9(cbits.numpy(), vhi.numpy(), vlo.numpy(), G, w)
            np.testing.assert_array_equal(got, want.numpy(),
                                          err_msg=f"G={G} W={w}")
            np.testing.assert_array_equal(got, model_k1(lv, 32, w)[0])


def test_k9_model_clamps_cbits_and_masks_values():
    """cbits is read clamped to [0, 64]; only the group's own bits of vhi
    and vlo reach the row, as in the plain version."""
    rng = np.random.default_rng(11)
    n, L1 = 40, 17
    cbits = rng.integers(-5, 80, (n, L1)).astype(np.int32)
    vhi = rng.integers(-2 ** 31, 2 ** 31, (n, L1)).astype(np.int32)
    vlo = rng.integers(-2 ** 31, 2 ** 31, (n, L1)).astype(np.int32)
    W = 70
    for G in LANES:
        want = K.encode_stream_rows_tables_plain(
            *(torch.from_numpy(x) for x in (cbits, vhi, vlo)), W)
        np.testing.assert_array_equal(model_k9(cbits, vhi, vlo, G, W),
                                      want.numpy())


def test_k9_model_equals_pallas_interpret(monkeypatch):
    """jpeg_tpu's tables kernel in interpret mode (L = 16, ENC_TILE cut to
    64) on jpeg_tpu's own tables, W exact and three words short (the rows
    of the blocks that still fit)."""
    monkeypatch.setenv("JPEG_TPU_PALLAS", "interpret")
    monkeypatch.setattr(PK, "ENC_TILE", 64)
    L = 16
    lv = _pallas_case(L, seed=9)
    cb, vh, vl, bb = (np.asarray(x) for x in JDC._unit_groups(jnp.asarray(lv)))
    W = -(-int(bb.max()) // 4)
    for w in (W, W - 3):
        want = np.asarray(PK.encode_stream_rows(
            jnp.asarray(cb), jnp.asarray(vh), jnp.asarray(vl), w,
            interpret=True))
        G = K.encode_rows_plan(len(lv), L + 1, w, SMS, tables=2).lanes
        fits = bb <= 4 * w          # longer blocks: see the K1 test above
        assert fits.sum() >= len(lv) - 8
        np.testing.assert_array_equal(model_k9(cb, vh, vl, G, w)[fits],
                                      want[fits])


# ---------------------------------------------------------------------------
# The plan and the sources
# ---------------------------------------------------------------------------

def test_plan_constants_are_the_sources():
    assert _const(BW, "kEncThreads") == K.ENC_THREADS
    assert _const(BW, "kEncRowMaxWords") == K.ENC_ROW_MAX_WORDS
    assert _const(BW, "kEncMaxSmem") == K.ENC_MAX_SMEM
    # one kernel a group size of ENC_LANES, in its order; no two-lane one
    assert LANES == (1, 4, 8, 16, 32)
    for src, name in ((K1_SRC, "encode_rows_kernel"),
                      (K9_SRC, "encode_tables_kernel")):
        assert re.findall(rf"{name}<(\d+)>", src) == [str(g) for g in LANES]
        assert '#include "bit_writer.cuh"' in src
    assert "kernels[lanes == 1 ? 0 : log2_lanes - 1]" in BW
    assert "lanes == 2 ||" in BW
    # the smem layout the plan mirrors
    assert "round4(tile * W)" in BW and "round4(tile)" in BW
    assert "int64_t(tables) * tile * (S | 1)" in BW
    # K1 stages its levels, K9 its group lengths and their low words
    assert "enc_run(kKernels, 1," in K1_SRC
    assert "enc_run(kKernels, 2," in K9_SRC
    # one lane a block writes one block a thread
    assert "(lanes == 1 && tile > kEncThreads)" in BW


def _launch_ok(S, W, plan, tables):
    """``jt::enc_launch``'s checks."""
    threads = min(plan.tile * plan.lanes, K.ENC_THREADS)
    return (plan.lanes in LANES and threads % 32 == 0
            and plan.tile % (threads // plan.lanes) == 0
            and (plan.lanes > 1 or plan.tile <= K.ENC_THREADS)
            and (not plan.smem_rows or W <= K.ENC_ROW_MAX_WORDS)
            and K.encode_rows_smem(S, W, plan, tables) <= K.ENC_MAX_SMEM)


@pytest.mark.parametrize("S", [0, 1, 2, 9, 10, 16, 17, 33, 64, 65, 129, 576,
                               577, 1024, 1025, 4096, K.ENC_MAX_L])
def test_plan_fits_and_launches(S):
    for n in (1, 33, 1452, 49152, 10 ** 6):
        for W in (1, 3, 12, 415, K.ENC_ROW_MAX_WORDS,
                  K.ENC_ROW_MAX_WORDS + 1, 737, 4096):
            for tables in (1, 2):
                plan = K.encode_rows_plan(n, S, W, SMS, tables)
                smem = K.encode_rows_smem(S, W, plan, tables)
                assert _launch_ok(S, W, plan, tables), (n, S, W, plan)
                # rows staged up to the row budget, else written in place
                assert plan.smem_rows == (W <= K.ENC_ROW_MAX_WORDS)
                # one lane a block from ENC_ONE_LANE_BLOCKS blocks an SM
                # per 64 slots, else the fewest lanes of 4 ... 32 that keep
                # ENC_WAVE_LANES lanes an SM busy (or one a slot) ...
                if n * 64 >= K.ENC_ONE_LANE_BLOCKS * SMS * max(S, 64):
                    lanes = 1
                else:
                    lanes = 4
                    while (lanes < 32 and lanes < S
                           and n * lanes < K.ENC_WAVE_LANES * SMS):
                        lanes *= 2
                assert plan.lanes >= lanes
                # ... unless the tile had to shrink below a warp (one lane
                # a block grows to four)
                if plan.lanes > lanes:
                    assert plan.tile * plan.lanes in (32, 64)
                # the tile halves only while over the staging budget
                assert smem <= K.ENC_STAGE_BYTES or plan.tile == 1
                assert plan.tile & (plan.tile - 1) == 0
                if plan.tile < K.ENC_THREADS // plan.lanes:
                    assert K.encode_rows_smem(
                        S, W, plan._replace(tile=2 * plan.tile),
                        tables) > K.ENC_STAGE_BYTES


def test_main_path_plans():
    """One lane a block at the 2048x2048 main path (N = 49,152, L = 64,
    W = 11) and its tables (65 slots, two tables staged), a warp a block
    on BASELINE (3)'s 1,452 blocks of 576 levels, 4 and 8 lanes on
    BASELINE (1)'s 12,288 and (2)'s 8,112 blocks; 2.9 KB rows at L = 1024
    (W = 737) are written in place."""
    assert K.encode_rows_plan(49152, 64, 11, SMS) == (1, 128, True)
    assert K.encode_rows_plan(49152, 65, 11, SMS, tables=2) == (1, 64, True)
    assert K.encode_rows_plan(1452, 576, 10, SMS) == (32, 4, True)
    assert K.encode_rows_plan(12288, 64, 28, SMS) == (4, 32, True)
    assert K.encode_rows_plan(8112, 64, 10, SMS) == (8, 16, True)
    assert not K.encode_rows_plan(5000, 1024, 737, SMS).smem_rows


def test_wrappers_bound_the_slots(monkeypatch):
    """The kernels take at most ENC_MAX_L slots a block (a one-block tile
    fits the card's shared memory); the plain versions, which CPU tensors
    run, take any L.  Patched to 8 slots: 9 levels run on the CPU, and the
    card's branch (forced here) raises before any launch."""
    monkeypatch.setattr(K, "ENC_MAX_L", 8)
    lv = torch.tensor([[5, 0, 0, 0, 0, 0, 0, 0, -3], [0] * 9],
                      dtype=torch.int32)
    cb, vh, vl, _ = DC._unit_groups(lv)
    want_rows, want_bb = K.encode_stream_rows_plain(lv, 4)
    rows, bb = K.encode_stream_rows(lv, 4)
    assert torch.equal(rows, want_rows) and torch.equal(bb, want_bb)
    assert torch.equal(K.encode_stream_rows_tables(cb, vh, vl, 4), want_rows)

    def no_launch(*a):
        raise AssertionError("launched")
    monkeypatch.setattr(K, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(K, "_launch", no_launch)
    with pytest.raises(ValueError, match="at most 8"):
        K.encode_stream_rows(lv, 4)
    with pytest.raises(ValueError, match="at most 8"):
        K.encode_stream_rows_tables(cb, vh, vl, 4)
    with pytest.raises(ValueError, match="W must be"):
        K.encode_stream_rows(lv, 0)
