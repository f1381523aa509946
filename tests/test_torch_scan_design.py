"""The Hopper designs of the boundary-scan kernels K6 (``scan_walk``) and
K7 / K8 (``chase_starts`` / ``chase_starts_multi``): their plans, models of
their phases, and their plain versions at the designs' edges, vs jpeg_tpu.

The CUDA kernels run only on a GPU, where chip_smoke.py holds them against
their plain versions on the same edges.  Here:

* The plans the wrappers compute in Python (``chase_plan``,
  ``walk_span_bytes``, ``scan_walk_plan``) are checked directly: the
  chase's short form below ``CHASE_DIRECT_MAX`` starts, the long form's
  anchors and fill ranges covering every start once, the constants the
  plans share with the CUDA sources, and K6's halo covering the longest
  walk the host scanner accepts, on worst-case streams made by the numpy
  encoder and on a longest walk built bit by bit.
* Models of the kernels in numpy (the short form and the long form's jump
  table, anchor chase and fill of ``csrc/chase.cu``, both at every edge;
  the staged tile, zero past ``n_bytes``, the global read past the staged
  bytes and any lane order of ``csrc/scan_walk.cu``) give exactly the
  plain versions' results.
* The plain K7 / K8 equal the serial chase and jpeg_tpu's Pallas
  ``chase_starts_multi`` in interpret mode at nb in {0, 1, k-1, k, k+1,
  3k+5}, with a chain start past P, a chain that meets ERR at its first
  step or mid-band, and B = 1, 3 and 64, and the serial chase around
  ``CHASE_DIRECT_MAX``; the plain K6 equals jpeg_tpu's XLA walker at the
  tile edges.  Every comparison is exact.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_tpu.entropy import device_scan as JDS
from jpeg_tpu.ops import pallas_kernels as PK

from jpeg_tpu_torch.config import BadStreamError
from jpeg_tpu_torch.entropy import numpy_codec as NC
from jpeg_tpu_torch.ops import kernels as K

torch.set_num_threads(2)

K_ = K.CHASE_JUMP
D_ = K.CHASE_DIRECT_MAX
EDGE_NB = (0, 1, K_ - 1, K_, K_ + 1, 3 * K_ + 5)
CSRC = os.path.join(os.path.dirname(K.__file__), os.pardir, "csrc")


def _levels(rng, n, L, density):
    lv = np.where(rng.random((n, L)) < density,
                  rng.integers(-900, 901, (n, L)), 0)
    return lv.astype(np.int32)


def _bands(nb, L=16, seed=0):
    """Three bands of nb blocks each, concatenated: (buffer, band ends,
    host starts of every block, band by band)."""
    rng = np.random.default_rng(seed)
    bands = [NC.encode_levels(_levels(rng, nb, L, d))
             for d in (0.2, 0.5, 0.05)]
    buf = b"".join(bands)
    ends = np.cumsum([len(b) for b in bands])
    offs = np.concatenate([[0], ends[:-1]])
    starts = [NC.scan_offsets(b, nb, L).astype(np.int64) + o
              for b, o in zip(bands, offs)]
    return buf, ends, starts


def _serial_chase(E, target, s0, nb):
    """The chase's definition, one step at a time."""
    P2 = len(E)
    starts, pos = [], s0
    for _ in range(nb):
        starts.append(pos)
        pos = int(E[min(max(pos, 0), P2 - 1)])
    return starts, pos == target


def _long_plan(P2, B, nb):
    """The long form's plan at any nb (the wrapper takes it above
    CHASE_DIRECT_MAX only)."""
    anchors = -(-nb // K_)
    return K.ChasePlan(anchors, P2, B * anchors)


def _chase_model(E, targets, s0s, nb, plan=None):
    """csrc/chase.cu in numpy, on the wrapper's plan or the one given: the
    short form's chain over E, or the long form's three phases (the kernel
    takes the short form at nb <= k whatever the plan)."""
    E = np.asarray(E, np.int64)
    P2, B = len(E), len(s0s)
    plan = plan or K.chase_plan(P2, B, nb)

    def f(x):
        return min(max(int(E[x]), 0), P2 - 1)

    starts = np.zeros((B, nb), np.int64)
    ok = np.zeros(B, bool)
    if plan.anchors == 0 or nb <= K_:                      # short form
        assert plan.anchors == 0 or plan.table_entries == P2
        for b in range(B):
            pos = min(max(s0s[b], 0), P2 - 1)
            for t in range(nb):
                starts[b, t] = s0s[b] if t == 0 else pos
                pos = f(pos)
            ok[b] = (pos if nb else s0s[b]) == targets[b]
        return starts, ok
    assert (plan.table_entries, plan.anchor_entries) == (P2, B * plan.anchors)
    J = np.arange(P2)                                      # phase 1
    for _ in range(K_):
        J = np.clip(E[J], 0, P2 - 1)
    for b in range(B):
        anchors = [min(max(s0s[b], 0), P2 - 1)]
        for _ in range(1, plan.anchors):                   # phase 2
            anchors.append(int(J[anchors[-1]]))
        for j, pos in enumerate(anchors):                  # phase 3
            first = j * K_
            cnt = min(K_, nb - first)
            for t in range(cnt):
                starts[b, first + t] = s0s[b] if t == j == 0 else pos
                pos = f(pos)
            if first + cnt == nb:
                ok[b] = pos == targets[b]
    return starts, ok


def _jax_chase(E, targets, s0s, nb):
    starts, ok = PK.chase_starts_multi(
        jnp.asarray(np.asarray(E, np.int32)),
        jnp.asarray(np.asarray(targets, np.int32)),
        jnp.asarray(np.asarray(s0s, np.int32)), nb, interpret=True)
    return np.asarray(starts), np.asarray(ok)


def _check_chase(E, targets, s0s, nb, jax_too=True):
    """Plain K8 (and K7 per band) == serial chase == the model of both
    forms (== jpeg_tpu's interpret-mode Pallas chase); returns the ok
    flags."""
    E_t = torch.from_numpy(np.asarray(E, np.int32))
    st, ok = K.chase_starts_multi(E_t, torch.tensor(targets, dtype=torch.int64),
                                  torch.tensor(s0s, dtype=torch.int64), nb)
    assert st.shape == (len(s0s), nb) and st.dtype == torch.int64
    models = [_chase_model(E, targets, s0s, nb),
              _chase_model(E, targets, s0s, nb,
                           _long_plan(len(E), len(s0s), nb))]
    for b, (t, s0) in enumerate(zip(targets, s0s)):
        want, want_ok = _serial_chase(E, t, s0, nb)
        assert st[b].tolist() == want and bool(ok[b]) == want_ok, b
        for model in models:
            assert model[0][b].tolist() == want and model[1][b] == want_ok, b
        one, one_ok = K.chase_starts(E_t, int(t), int(s0), nb)
        assert one.tolist() == want and bool(one_ok) == want_ok, b
    if jax_too:
        jst, jok = _jax_chase(E, targets, s0s, nb)
        np.testing.assert_array_equal(jst, st.numpy())
        np.testing.assert_array_equal(jok, ok.numpy())
    return ok.numpy()


def _end_table(buf: bytes, n_bytes: int, L: int) -> np.ndarray:
    return K.scan_walk(torch.frombuffer(bytearray(buf), dtype=torch.uint8),
                       n_bytes, L).numpy()


# ---------------------------------------------------------------------------
# K7 / K8: the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb", [0, 1, K_ - 1, K_, K_ + 1, 3 * K_ + 5, D_,
                                D_ + 1, D_ + K_, D_ + K_ + 1, 16384])
def test_chase_plan_covers_every_start_once(nb):
    P2, B = 1000, 3
    plan = K.chase_plan(P2, B, nb)
    if nb <= D_:                                    # the short form: no
        assert plan == (0, 0, 0)                    # scratch, one launch
        plan = _long_plan(P2, B, nb)                # (the long one's ranges)
    else:                                           # phases 1 and 2 run
        assert plan.anchors == -(-nb // K_) >= 2
        assert (plan.table_entries, plan.anchor_entries) == (P2,
                                                             B * plan.anchors)
    covered = [0] * nb
    for j in range(plan.anchors):                   # phase 3's fill ranges
        for i in range(j * K_, min((j + 1) * K_, nb)):
            covered[i] += 1
    assert covered == [1] * nb
    # the serial steps per band: anchors - 1 jumps, then at most k fills
    assert plan.anchors - 1 + min(nb, K_) <= max(nb, 1)


def _constant(source, name):
    with open(os.path.join(CSRC, source)) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);", f.read())[1])


def test_chase_plan_takes_the_jump_it_is_given():
    """The plan's k is the kernel's, and the long form starts past
    CHASE_DIRECT_MAX with at least two anchors a band."""
    assert _constant("chase.cu", "kJump") == K_
    assert D_ >= K_
    assert K.chase_plan(50, 2, D_) == (0, 0, 0)
    a = -(-(D_ + 100) // K_)
    assert K.chase_plan(50, 2, D_ + 100) == (a, 50, 2 * a)


def test_scan_walk_plan_shares_the_kernel_constants():
    assert _constant("scan_walk.cu", "kThreads") == K.SCAN_THREADS
    assert _constant("scan_walk.cu", "kUnitsPerRound") == \
        K.SCAN_UNITS_PER_ROUND
    with pytest.raises(ValueError, match="L must be"):
        K.scan_walk(torch.zeros(8, dtype=torch.uint8), 8, K.SCAN_MAX_L + 1)
    # the longest walk from a tile's last byte stays inside int32 bits
    assert 8 * K.SCAN_TILE_MAX + 23 * K._walk_units(K.SCAN_MAX_L) < 1 << 31


# ---------------------------------------------------------------------------
# K7 / K8: plain versions and the phase model at the design's edges
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb", EDGE_NB)
def test_chase_edge_block_counts(nb):
    """B = 3 chains from the band starts, nb blocks each: when the target
    is the host start nb blocks on (or the band's end), every chain is
    accepted and its starts are the host scanner's; one chain aims one byte
    short and fails."""
    buf, ends, host = _bands(3 * K_ + 5)
    E = _end_table(buf, len(buf), 16)
    s0s = [int(h[0]) for h in host]
    targets = [int(h[nb]) if nb < len(h) else int(e)
               for h, e in zip(host, ends)]
    ok = _check_chase(E, targets, s0s, nb)
    assert ok.all()
    st, _ = K.chase_starts_multi(torch.from_numpy(E), torch.tensor(targets),
                                 torch.tensor(s0s), nb)
    for b in range(3):
        assert st[b].tolist() == host[b][:nb].tolist()
    targets[1] -= 1
    assert _check_chase(E, targets, s0s, nb).tolist() == [True, False, True]


def test_chase_start_past_the_stream():
    """A chain start past P (and a negative one) clamps into the table: the
    chain sits on ERR; starts[0] keeps the start as given.  jpeg_tpu's
    Pallas chase pads its table differently beyond P2, so it is held only
    where the starts lie in [0, P2)."""
    buf, ends, host = _bands(40)
    E = _end_table(buf, len(buf), 16)
    P = len(buf)
    for nb in (1, K_ + 1, 3 * K_ + 5):
        ok = _check_chase(E, [P + 1, P + 1, 0], [P, P + 1, P], nb)
        assert ok.tolist() == [True, True, False]
        _check_chase(E, [P + 1] * 3, [P + 7, 1 << 40, -5], nb, jax_too=False)
    st, _ = K.chase_starts_multi(torch.from_numpy(E), torch.tensor([0]),
                                 torch.tensor([P + 7]), 5)
    assert st.tolist() == [[P + 7] + [P + 1] * 4]


@pytest.mark.parametrize("where", ["first step", "mid-band"])
def test_chase_meets_err(where):
    """A chain whose next start is ERR (at its first step, or at block
    K_ + 3 of the band) stays on ERR and fails its check; the other bands
    are untouched."""
    nb = 3 * K_ + 5
    buf, ends, host = _bands(nb, seed=4)
    E = _end_table(buf, len(buf), 16)
    err = len(buf) + 1
    at = 0 if where == "first step" else K_ + 3
    E[host[1][at]] = err
    ok = _check_chase(E, [int(e) for e in ends], [int(h[0]) for h in host],
                      nb)
    assert ok.tolist() == [True, False, True]
    st, _ = K.chase_starts_multi(torch.from_numpy(E),
                                 torch.tensor([int(e) for e in ends]),
                                 torch.tensor([int(h[0]) for h in host]), nb)
    assert st[1, :at + 1].tolist() == host[1][:at + 1].tolist()
    assert (st[1, at + 1:] == err).all()


def test_chase_one_band_is_k7():
    """B = 1: chase_starts and chase_starts_multi agree with each other,
    the phase model and the Pallas chase."""
    nb = 3 * K_ + 5
    buf, ends, host = _bands(nb, seed=2)
    E = _end_table(buf, len(buf), 16)
    assert _check_chase(E, [int(ends[0])], [0], nb).tolist() == [True]
    starts, ok = K.chase_starts(torch.from_numpy(E), int(ends[0]), 0, nb)
    assert starts.shape == (nb,) and ok.shape == () and bool(ok)
    assert starts.tolist() == host[0].tolist()


def test_chase_64_chains_on_one_buffer():
    """B = 64 chains over one buffer, from every 7th block start of the
    three bands, each nb blocks on: accepted where the target is the host
    start nb blocks on, refused where it is one byte past it."""
    nb = K_ + 7
    buf, ends, host = _bands(300, seed=3)
    allstarts = np.concatenate(host + [[len(buf)]])
    idx = np.arange(64) * 7
    s0s = [int(allstarts[i]) for i in idx]
    targets = [int(allstarts[i + nb]) + (i % 2) for i in idx]
    E = _end_table(buf, len(buf), 16)
    ok = _check_chase(E, targets, s0s, nb, jax_too=False)
    assert ok.tolist() == [i % 2 == 0 for i in idx]
    jst, jok = _jax_chase(E, targets, s0s, nb)       # one Pallas call
    st, _ = K.chase_starts_multi(torch.from_numpy(E), torch.tensor(targets),
                                 torch.tensor(s0s), nb)
    np.testing.assert_array_equal(jst, st.numpy())
    np.testing.assert_array_equal(jok, ok)


@pytest.mark.parametrize("nb", [D_, D_ + 1, D_ + K_, D_ + K_ + 1])
def test_chase_at_the_selection_edge(nb):
    """Around CHASE_DIRECT_MAX, where the wrapper moves from the short form
    to the long one: both forms' models give the serial chase's starts, the
    host starts, and the check; a target one byte short fails."""
    buf, ends, host = _bands(D_ + K_ + 1, seed=5)
    E = _end_table(buf, len(buf), 16)
    s0s = [int(h[0]) for h in host]
    targets = [int(h[nb]) if nb < len(h) else int(e)
               for h, e in zip(host, ends)]
    targets[2] -= 1
    ok = _check_chase(E, targets, s0s, nb, jax_too=False)
    assert ok.tolist() == [True, True, False]
    st, _ = K.chase_starts_multi(torch.from_numpy(E), torch.tensor(targets),
                                 torch.tensor(s0s), nb)
    for b in range(3):
        assert st[b].tolist() == host[b][:nb].tolist()


# ---------------------------------------------------------------------------
# K6: the plan and its halo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L,span", [(16, 53), (64, 200), (576, 1770)])
def test_scan_walk_plan(L, span):
    """The halo covers a walk's span; the main-path stream on an H100's
    132 multiprocessors fills the card in one wave of 8 blocks each."""
    assert K.walk_span_bytes(L) == span
    P = 1_387_909
    plan = K.scan_walk_plan(P, L, 132)
    assert plan.halo % 16 == 0 and span <= plan.halo < span + 16
    assert plan.halo <= K.SCAN_HALO_MAX
    assert plan.tile % 16 == 0 and plan.tile == 1328
    blocks = -(-(P + 2) // plan.tile)                 # one per tile
    assert blocks <= 132 * 2048 // K.SCAN_THREADS     # one wave
    # shared memory: an int32 end and a byte per tile entry, and the halo
    assert 5 * plan.tile + plan.halo <= 48 << 10
    # small streams: tiles of a walk per lane, whatever the halo
    assert K.scan_walk_plan(1000, L, 132).tile == K.SCAN_THREADS == 256
    assert K.scan_walk_plan(42_408, L, 132).tile == 256
    # large streams: tiles of at most SCAN_TILE_MAX, in several waves
    big = K.scan_walk_plan(1 << 30, L, 132)
    assert big.tile == K.SCAN_TILE_MAX
    # a longer walk than the cap reads past the halo from global memory
    assert K.scan_walk_plan(10, 1024, 132).halo == K.SCAN_HALO_MAX < \
        K.walk_span_bytes(1024)


def _longest_walk(L, extra_chains=0):
    """One block of the longest walk the host scanner accepts, bit by bit:
    L codes of size 15 (23 bits each), then zero-run chains to the unit
    budget, then EOB, padded to a byte."""
    bits = "0000" "1111" + "1" * 15                   # (0, 15) + magnitude
    chains = K._walk_units(L) - L - 1 + extra_chains
    s = bits * L + "11110000" * chains + "00000000"
    s += "0" * (-len(s) % 8)
    return int(s, 2).to_bytes(len(s) // 8, "big")


@pytest.mark.parametrize("L", [16, 64, 576])
def test_halo_covers_the_longest_accepted_walks(L):
    """Every block the host scanner accepts fits in walk_span_bytes(L):
    the numpy encoder's worst cases (every coefficient at the largest size;
    a lone last coefficient after chained zero runs; both mixed) and the
    longest walk the rules allow, built bit by bit."""
    lv = np.zeros((6, L), np.int32)
    lv[0] = 16383                                     # every coefficient,
    lv[1] = -16383                                    # the largest size
    lv[2, L - 1] = -16383                             # chains, then a code
    lv[3, ::16] = 16383                               # chains between codes
    lv[4, 1::2] = -16383
    data = NC.encode_levels(lv)
    starts = NC.scan_offsets(data, 6, L)
    lengths = np.diff(np.append(starts, len(data)))
    assert lengths[0] == -(-(23 * L + 8) // 8)
    longest = _longest_walk(L)
    NC.scan_offsets(longest, 1, L)                    # the host accepts it
    assert len(longest) > lengths.max()
    assert len(longest) <= K.walk_span_bytes(L) <= \
        K.scan_walk_plan(1, L, 132).halo
    # one more chain and the host scanner refuses it (the unit budget)
    with pytest.raises(BadStreamError):
        NC.scan_offsets(_longest_walk(L, extra_chains=1), 1, L)


# ---------------------------------------------------------------------------
# K6: a model of the tiled walk, and the plain version at the tile edges
# ---------------------------------------------------------------------------

def _tile_model(buf: bytes, n_bytes: int, L: int, seed: int = 0):
    """csrc/scan_walk.cu's single sweep in Python, on the wrapper's plan:
    per tile, the staged bytes (zero past n_bytes and P) read through a
    two-byte window, global reads past them, walkers in a random order."""
    P = len(buf)
    plan = K.scan_walk_plan(P, L, sms=1)
    limit, err = 8 * n_bytes, P + 1
    pad = buf + bytes(5)
    rng = np.random.default_rng(seed)
    E = np.full(P + 2, err, np.int64)
    reads = {"tile": 0, "global": 0}
    for first in range(0, P + 2, plan.tile):
        staged = bytearray(plan.tile + plan.halo)
        for i in range(len(staged)):
            if first + i < min(n_bytes, P):
                staged[i] = buf[first + i]

        def header(bit):
            b, o = (bit >> 3) - first, bit & 7
            if 0 <= b and b + 1 < len(staged):
                reads["tile"] += 1
                return ((staged[b] << 8 | staged[b + 1]) >> (8 - o)) & 0xFF
            reads["global"] += 1
            w = int.from_bytes(pad[bit >> 3:(bit >> 3) + 5], "big")
            return (w >> (8 - o)) >> 24 & 0xFF

        for q in rng.permutation(max(0, min(P - first, plan.tile))):
            pos, widx = 8 * (first + q), 0
            for _ in range(K._walk_units(L)):
                if pos + 8 > limit:
                    break
                h = header(pos)
                if h == 0:
                    E[first + q] = (pos + 15) >> 3
                    break
                if h == 0xF0:
                    widx, pos = widx + 15, pos + 8
                    continue
                run, size = h >> 4, h & 15
                if size == 0 or pos + 8 + size > limit or widx + run >= L:
                    break
                widx, pos = widx + run + 1, pos + 8 + size
    return E, reads


def _k6_case(case):
    """(buffer, n_bytes, L) of one tile-edge case (tiles of 256 bytes)."""
    rng = np.random.default_rng(7)
    if case == "buffer longer than n_bytes":
        data = NC.encode_levels(_levels(rng, 40, 64, 0.3))
        return data + rng.integers(0, 256, 300, dtype=np.uint8).tobytes(), \
            len(data), 64
    if case == "d = 24 stream":
        lv = _levels(rng, 6, 576, 0.08)
        lv[2] = 16383                                 # a 1.6 KB block
        data = NC.encode_levels(lv)
        return data, len(data), 576
    if case == "one block shorter than a tile":
        data = NC.encode_levels(_levels(rng, 1, 64, 0.5))
        return data, len(data), 64
    if case == "tile boundary inside a zero-run chain":
        lv = np.zeros((30, 576), np.int32)
        lv[:, 575] = 9                                # 38 chains, a code
        data = NC.encode_levels(lv)
        return data, len(data), 576
    assert case == "walks past the halo"
    lv = np.full((3, 1024), -16383, np.int32)         # 2.9 KB blocks
    data = NC.encode_levels(lv)
    return data, len(data), 1024


K6_CASES = ["buffer longer than n_bytes", "d = 24 stream",
            "one block shorter than a tile",
            "tile boundary inside a zero-run chain", "walks past the halo"]


@pytest.mark.parametrize("case", K6_CASES)
def test_scan_walk_tile_edges(case, monkeypatch):
    """The tiled walk's model (tiles of 256 bytes), the plain K6 and
    jpeg_tpu's XLA walker give the same end table; the chase over it
    accepts exactly the stream's own blocks."""
    monkeypatch.setattr(K, "SCAN_TILE_MAX", 256)
    buf, n, L = _k6_case(case)
    plain = _end_table(buf, n, L)
    jax_E = np.asarray(JDS._end_table_xla(
        jnp.asarray(np.frombuffer(buf, np.uint8)), len(buf),
        jnp.int32(8 * n), L))
    np.testing.assert_array_equal(plain, jax_E)
    model, reads = _tile_model(buf, n, L, seed=len(case))
    np.testing.assert_array_equal(model, plain)
    halo = K.scan_walk_plan(len(buf), L, sms=1).halo
    assert (reads["global"] > 0) == (K.walk_span_bytes(L) > halo), reads
    if case == "tile boundary inside a zero-run chain":
        # a run of 0xF0 bytes crosses a tile boundary
        assert buf[255] == buf[256] == 0xF0 or buf[511] == buf[512] == 0xF0
    nb = {"one block shorter than a tile": 1, "d = 24 stream": 6,
          "tile boundary inside a zero-run chain": 30,
          "walks past the halo": 3}.get(case, 40)
    host = NC.scan_offsets(buf[:n], nb, L)
    starts, ok = K.chase_starts(torch.from_numpy(plain.astype(np.int32)), n,
                                0, nb)
    assert bool(ok) and starts.tolist() == host.tolist()
