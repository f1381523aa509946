"""The Hopper design of K6' (``ops/kernels.py``: ``scan_walk_capped``, the
range form, and ``scan_walk_resume``, the list form; ``csrc/scan_walk.cu``):
the two-sweep end table as two launches, vs its plain versions and jpeg_tpu.

The CUDA kernels run only on a GPU, where chip_smoke.py holds both forms
against their plain versions.  Here:

* A numpy model of the kernels: sweep 1 stages each tile of the plan and
  a halo of ``capped_span_bytes`` (zero past ``n_bytes`` and P), reads
  headers through a two-byte window, writes E and appends the walkers
  live at the cap to a survivor list in any warp order; sweep 2 resumes
  the list, in any order, through the kernel's 64-bit bit buffer of
  big-endian words.  With ``SCAN_TILE_MAX`` patched to 256 it gives the
  plain versions' table, survivors and per-walker outputs exactly, and no
  capped walk reads past its tile's staged bytes.
* A survivor list in any permutation gives the same table; the range form
  equals the list form on the explicit ``q = arange(P)``.
* The halo covers the longest capped walks, built by hand: all (15, 15)
  codes, and chains of 0xF0.
* The constants and entry-point arities the wrappers share with
  ``csrc/scan_walk.cu`` are read from the source.
* ``end_table(cap=c)`` equals ``end_table(cap=0)`` and jpeg_tpu's
  ``_end_table_xla`` for c in {1, 4, 12, budget - 1, budget, 1000}, on real
  blocks, on a stream where every walker the stream's end does not stop
  survives, and on one where no walker survives.

Every comparison is exact.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_tpu.entropy import device_scan as JDS

from jpeg_tpu_torch.entropy import device_scan as DS
from jpeg_tpu_torch.entropy import numpy_codec as NC
from jpeg_tpu_torch.ops import kernels as K

torch.set_num_threads(2)

CSRC = os.path.join(os.path.dirname(K.__file__), os.pardir, "csrc")
TILE = 256                     # SCAN_TILE_MAX for the models


def _u8(buf: bytes) -> torch.Tensor:
    return torch.frombuffer(bytearray(buf), dtype=torch.uint8)


def _levels(rng, n, L, density):
    lv = np.where(rng.random((n, L)) < density,
                  rng.integers(-900, 901, (n, L)), 0)
    return lv.astype(np.int32)


def _case(name):
    """(buffer, n_bytes, L) of one stream."""
    rng = np.random.default_rng(len(name))
    if name == "real blocks":
        data = NC.encode_levels(_levels(rng, 40, 64, 0.3))
        return data, len(data), 64
    if name == "buffer longer than n_bytes":
        data = NC.encode_levels(_levels(rng, 30, 64, 0.2))
        return data + rng.integers(0, 256, 300, dtype=np.uint8).tobytes(), \
            len(data), 64
    if name == "one block, below one tile":
        data = NC.encode_levels(_levels(rng, 1, 64, 0.5))
        return data, len(data), 64
    if name == "garbage":
        buf = rng.integers(0, 256, 900, dtype=np.uint8).tobytes()
        return buf, len(buf) - 7, 64
    if name == "zero-run chains, L = 576":
        lv = np.zeros((8, 576), np.int32)
        lv[:, 575] = 9                                # 38 chains, a code
        lv[3, ::7] = 300
        data = NC.encode_levels(lv)
        return data, len(data), 576
    assert name == "0xF0 chains"
    buf = b"\xf0" * 700
    return buf, len(buf), 64


CASES = ["real blocks", "buffer longer than n_bytes",
         "one block, below one tile", "garbage", "zero-run chains, L = 576",
         "0xF0 chains"]


# ---------------------------------------------------------------------------
# The numpy model of csrc/scan_walk.cu's two sweeps
# ---------------------------------------------------------------------------

def _walk(header, pos, widx, limit, L, units):
    """csrc/scan_walk.cuh ``walk()``: (status, pos, widx)."""
    for _ in range(units):
        if pos + 8 > limit:
            return "err", pos, widx
        h = header(pos)
        if h == 0:
            return "done", pos, widx
        if h == 0xF0:
            widx, pos = widx + 15, pos + 8
            continue
        run, size = h >> 4, h & 15
        if size == 0 or pos + 8 + size > limit or widx + run >= L:
            return "err", pos, widx
        widx, pos = widx + run + 1, pos + 8 + size
    return "live", pos, widx


class _StreamBits:
    """csrc/scan_walk.cuh ``StreamBits``: a 64-bit buffer of big-endian
    words, zero outside [0, P); one word taken when a header starts 32
    bits or more into it."""

    def __init__(self, buf: bytes, start: int, pos: int):
        self.buf_bytes = buf
        w = (start + pos) >> 5
        self.base = w * 32 - start
        self.bits = (self._word(w) << 32) | self._word(w + 1)
        self.next = w + 2
        self.words = 2

    def _word(self, w):
        return int.from_bytes(bytes(
            self.buf_bytes[b] if 0 <= b < len(self.buf_bytes) else 0
            for b in range(4 * w, 4 * w + 4)), "big")

    def __call__(self, bit):
        off = bit - self.base
        assert 0 <= off < 32 + 23, off         # one word a header suffices
        if off >= 32:
            self.bits = ((self.bits << 32) & (2 ** 64 - 1)) | \
                self._word(self.next)
            self.next += 1
            self.words += 1
            self.base += 32
            off -= 32
        return (self.bits >> (56 - off)) & 0xFF


def _sweep1_model(buf: bytes, n_bytes: int, L: int, cap: int, rng):
    """The range form on the wrapper's plan (tiles of TILE bytes): E with
    ERR where a walker is live at the cap, the survivor list in the order
    the model's warps append it, every walker's (length, bits, index), and
    how many headers came from the staged bytes and from global memory."""
    P = len(buf)
    budget = K._walk_units(L)
    cap = min(cap, budget)
    plan = K.scan_walk_plan(P, L, 1, cap)
    limit, err = 8 * n_bytes, P + 1
    pad = buf + bytes(5)
    E = np.full(P + 2, err, np.int64)
    walkers = np.zeros((3, P), np.int64)
    survivors = []
    reads = {"tile": 0, "global": 0}
    for first in range(0, P + 2, plan.tile):
        staged = bytearray(plan.tile + plan.halo)
        for i in range(len(staged)):
            if first + i < min(n_bytes, P):
                staged[i] = buf[first + i]

        def header(bit):                         # bits from the tile
            b, o = bit >> 3, bit & 7
            if b + 1 < len(staged):
                reads["tile"] += 1
                return ((staged[b] << 8 | staged[b + 1]) >> (8 - o)) & 0xFF
            reads["global"] += 1
            g = first * 8 + bit
            w = int.from_bytes(pad[g >> 3:(g >> 3) + 5], "big")
            return (w >> (8 - (g & 7))) >> 24 & 0xFF

        todo = max(0, min(P - first, plan.tile))
        # warps of 32 walkers in a random order, each appending its round's
        # survivors at once
        order = rng.permutation(todo)
        for warp in np.array_split(order, max(1, -(-todo // 32))):
            appended = []
            for q in map(int, warp):
                st, pos, widx = _walk(header, 8 * q, 0,
                                      limit - 8 * first, L, cap)
                c = pos - 8 * q
                walkers[:, first + q] = (
                    (c + 15) >> 3 if st == "done" else
                    -1 if st == "err" else -2, c, widx)
                if st == "done":
                    E[first + q] = first + ((pos + 15) >> 3)
                elif st == "live" and cap < budget:
                    appended.append((first + q, c, widx))
            survivors += [appended[i] for i in rng.permutation(len(appended))]
    return E, survivors, walkers, reads


def _sweep2_model(buf: bytes, n_bytes: int, L: int, steps: int, survivors,
                  E):
    """The list form: each survivor resumed through the bit buffer."""
    E = E.copy()
    err = len(buf) + 1
    for q, c, w in survivors:
        rd = _StreamBits(buf, 8 * q, c)
        st, pos, _ = _walk(rd, c, w, 8 * n_bytes - 8 * q, L, steps)
        E[q] = q + ((pos + 15) >> 3) if st == "done" else err
    return E


def _jax_table(buf: bytes, n: int, L: int) -> np.ndarray:
    return np.asarray(JDS._end_table_xla(
        jnp.asarray(np.frombuffer(buf, np.uint8)), len(buf), jnp.int32(8 * n),
        L))


def _resume(st, n, L, steps, surv, E):
    """Sweep 2: ``surv`` resumed by the list form into E."""
    return K.scan_walk_resume(st, n, L, surv.q, steps, surv.c, surv.w,
                              surv.n, table=E)


def _survivor_set(surv):
    n = int(surv.n[0])
    return sorted(zip(surv.q[:n].tolist(), surv.c[:n].tolist(),
                      surv.w[:n].tolist()))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("cap", [4, 12])
def test_two_sweep_model_equals_plain(case, cap, monkeypatch):
    """The model's sweeps give the plain versions' table, survivors (as a
    set) and per-walker outputs; the capped walks read only staged bytes;
    and the table is the single sweep's and jpeg_tpu's."""
    monkeypatch.setattr(K, "SCAN_TILE_MAX", TILE)
    buf, n, L = _case(case)
    rng = np.random.default_rng(cap)
    budget = K._walk_units(L)
    E1, surv_m, walkers, reads = _sweep1_model(buf, n, L, cap, rng)
    st = _u8(buf)
    E_p, surv_p = K.scan_walk_capped(st, n, L, cap)
    np.testing.assert_array_equal(E1, E_p.numpy())
    assert sorted(surv_m) == _survivor_set(surv_p)
    got = K.scan_walk_resume(st, n, L, torch.arange(len(buf)), cap)
    for name, g, w in zip(("lengths", "bits", "indices"), got, walkers):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert reads["global"] == 0 and reads["tile"] > 0
    E2 = _sweep2_model(buf, n, L, budget - cap, surv_m, E1)
    E_two = _resume(st, n, L, budget - cap, surv_p, E_p)
    np.testing.assert_array_equal(E2, E_two.numpy())
    np.testing.assert_array_equal(E2, DS.end_table(st, n, L).numpy())
    np.testing.assert_array_equal(E2, _jax_table(buf, n, L))
    if case == "0xF0 chains":
        assert len(surv_m) == len(buf) - cap + 1   # all the end leaves


@pytest.mark.parametrize("case", ["real blocks", "0xF0 chains",
                                  "zero-run chains, L = 576"])
def test_survivors_in_any_order_give_one_table(case):
    """Sweep 2 over the survivor list in any permutation (and the model's
    bit buffer over it) writes the same table."""
    buf, n, L = _case(case)
    st = _u8(buf)
    cap = 3
    steps = K._walk_units(L) - cap
    E1, surv = K.scan_walk_capped(st, n, L, cap)
    want = _resume(st, n, L, steps, surv, E1.clone())
    k = int(surv.n[0])
    assert k > 0
    rng = np.random.default_rng(5)
    for _ in range(3):
        perm = torch.from_numpy(rng.permutation(k))
        shuffled = K.ScanSurvivors(surv.q.clone(), surv.c.clone(),
                                   surv.w.clone(), surv.n)
        for t, src in zip(shuffled[:3], surv[:3]):
            t[:k] = src[:k][perm]
        got = _resume(st, n, L, steps, shuffled, E1.clone())
        assert torch.equal(got, want)
        model = _sweep2_model(buf, n, L, steps, list(zip(
            *(t[:k].tolist() for t in shuffled[:3]))), E1.numpy())
        np.testing.assert_array_equal(model, want.numpy())
    # a count below the list's length resumes only the first walkers
    part = K.ScanSurvivors(*surv[:3], torch.tensor([k // 2]))
    got = _resume(st, n, L, steps, part, E1.clone())
    q_rest = surv.q[k // 2:k]
    assert (got[q_rest] == len(buf) + 1).all()
    assert torch.equal(got[surv.q[:k // 2]], want[surv.q[:k // 2]])


@pytest.mark.parametrize("case", CASES)
def test_range_form_equals_explicit_q(case):
    """The range form (``scan_walk_capped``) gives what the list form gives
    on q = arange(P), c0 = w0 = 0: the table of the settled walkers, ERR
    for the rest, and the walkers live at the cap as its survivors, at
    every cap; the list form's defaults are that explicit form, and at
    cap 0 (the whole budget) it gives the single sweep's table."""
    buf, n, L = _case(case)
    P = len(buf)
    st = _u8(buf)
    q = torch.arange(P)
    zero = torch.zeros(P, dtype=torch.int32)
    budget = K._walk_units(L)
    for cap in (0, 1, 4, 12, budget - 1, budget, 1000):
        length, c, w = K.scan_walk_resume(st, n, L, q, cap)
        for x, y in zip((length, c, w), K.scan_walk_resume(
                st, n, L, q, cap, zero, zero, torch.tensor(P))):
            assert x.dtype == torch.int32 and x.shape == (P,)
            assert torch.equal(x, y), cap
        E = torch.full((P + 2,), P + 1, dtype=torch.int32)
        E[:P] = torch.where(length >= 0, q + length, P + 1).to(torch.int32)
        if cap == 0:
            assert torch.equal(E, K.scan_walk(st, n, L))
            continue
        E_c, surv = K.scan_walk_capped(st, n, L, cap)
        assert torch.equal(E_c, E), cap
        live = length == -2
        if cap >= budget:
            assert surv is None         # a live walker is ERR there
            continue
        assert _survivor_set(surv) == sorted(zip(
            q[live].tolist(), c[live].tolist(), w[live].tolist())), cap


def test_range_form_takes_no_carried_state():
    """``scan_walk_capped`` takes no walker list and starts every walker at
    its block's start; the list form's table output checks its table; the
    plain versions launch nothing."""
    import inspect
    assert list(inspect.signature(K.scan_walk_capped).parameters) == [
        "stream", "n_bytes", "L", "cap"]
    st = torch.zeros(8, dtype=torch.uint8)
    with pytest.raises(ValueError, match="cap must be >= 1"):
        K.scan_walk_capped(st, 8, 16, 0)
    E, surv = K.scan_walk_capped(st, 8, 16, 2)
    assert E.shape == (10,) and surv is not None
    with pytest.raises(ValueError, match="cap must be >= 0"):
        _resume(st, 8, 16, -1, surv, E)
    with pytest.raises(ValueError, match="10 entries"):
        _resume(st, 8, 16, 3, surv, E[:9])
    with pytest.raises(ValueError, match="int32"):
        _resume(st, 8, 16, 3, surv, E.long())
    with pytest.raises(ValueError, match="different devices"):
        _resume(st, 8, 16, 3, surv, E.to("meta"))
    before = K.launch_counts()
    _resume(st, 8, 16, 3, surv, E)
    DS.end_table_two_sweep(st, 8, 16, 4)
    assert K.launch_counts() == before     # the plain versions launch nothing


# ---------------------------------------------------------------------------
# The halo, the constants and the entry points
# ---------------------------------------------------------------------------

def _longest_capped(kind: str, units: int) -> bytes:
    """``units`` (15, 15) codes (23 bits each) or 0xF0 chains, then EOB."""
    code = "1111" "1111" + "1" * 15 if kind == "(15, 15)" else "11110000"
    s = code * units + "00000000"
    s += "0" * (-len(s) % 8)
    return int(s, 2).to_bytes(len(s) // 8, "big")


@pytest.mark.parametrize("kind", ["(15, 15)", "0xF0"])
@pytest.mark.parametrize("cap", [1, 2, 4, 8, 12, 20, 40])
def test_halo_covers_the_longest_capped_walks(kind, cap):
    """A walk capped at ``cap`` units over the longest units there are
    reads no byte past ``capped_span_bytes(L, cap)``, the plan's halo holds
    it, and the span is ceil((8 + 23 cap) / 8) bytes while the cap is
    below the budget."""
    L = 1024                                # 16 cap < L: no index overflow
    buf = _longest_capped(kind, cap + 3)
    top = [0]

    def header(bit):
        top[0] = max(top[0], (bit >> 3) + 1)
        w = (buf[bit >> 3] << 8) | buf[(bit >> 3) + 1]
        return (w >> (8 - (bit & 7))) & 0xFF

    st, pos, widx = _walk(header, 0, 0, 8 * len(buf), L, cap)
    assert st == "live"
    assert widx == (16 if kind == "(15, 15)" else 15) * cap
    span = K.capped_span_bytes(L, cap)
    assert span == -(-(8 + 23 * cap) // 8)
    assert top[0] + 1 <= span               # bytes [0, top] were read
    # so do the bits of the header the resumed walker reads first
    assert -(-(pos + 8) // 8) <= span
    plan = K.scan_walk_plan(10_000, L, 132, cap)
    assert plan.halo == -(-span // 16) * 16 and plan.halo % 16 == 0
    # past the budget the span is the whole walk's
    assert K.capped_span_bytes(L, 10 ** 6) == K.walk_span_bytes(L)
    assert K.capped_span_bytes(L, 0) == K.walk_span_bytes(L)


def test_halo_at_the_main_path_caps():
    """At L = 64 the caps chip_smoke.py times stage 32 to 64 bytes past a
    tile, against 208 for the whole walk."""
    assert [K.scan_walk_plan(1_387_909, 64, 132, c).halo
            for c in (8, 12, 20, 0)] == [32, 48, 64, 208]


def _source():
    with open(os.path.join(CSRC, "scan_walk.cu")) as f:
        return f.read()


def test_constants_and_entry_points_are_the_sources():
    """The threads, units a round and modes of csrc/scan_walk.cu, and the
    arity of each entry point against the ctypes signatures."""
    src = _source()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert constant("kThreads") == K.SCAN_THREADS
    assert constant("kUnitsPerRound") == K.SCAN_UNITS_PER_ROUND
    assert re.search(r"enum Mode : int \{ kTable = 0, kCapped = 1 \};",
                     src)
    for name in ("jt_scan_walk", "jt_scan_walk_capped",
                 "jt_scan_walk_resume"):
        params = re.search(rf"JT_API int {name}\((.*?)\)", src, re.S)[1]
        assert len(params.split(",")) == len(K._SIGNATURES[name]), name
    # the old per-thread resume kernel is gone; both sweeps share walk()
    assert "scan_walk_resume_kernel" not in src
    assert src.count("walk(rd, ") == 2
    # sweep 1 zeroes the count itself: one memset, no torch.zeros
    assert src.count("cudaMemsetAsync") == 1
    assert K.scan_resume_blocks(1, 132) == 1
    assert K.scan_resume_blocks(1_387_909, 132) == (
        132 * 2048 // 256 * K.SCAN_RESUME_EIGHTHS // 8)
    assert K.scan_resume_blocks(0, 132) == 1
    assert 1 <= K.SCAN_RESUME_EIGHTHS <= 8


# ---------------------------------------------------------------------------
# end_table(cap=c) against the single sweep and jpeg_tpu
# ---------------------------------------------------------------------------

def _stream(kind: str):
    rng = np.random.default_rng(11)
    L = 64
    if kind == "real blocks":
        lv = _levels(rng, 60, L, 0.15)
        lv[5, L - 1] = 7
        data = NC.encode_levels(lv)
        return data + bytes(5), len(data), L
    if kind == "every walker survives":
        buf = b"\xf0" * 500
        return buf, len(buf), L
    assert kind == "no walker survives"
    buf = rng.choice(np.array([0x00, 0x10, 0x20, 0x70, 0xE0], np.uint8),
                     600).tobytes()
    return buf, len(buf), L


@pytest.mark.parametrize("kind", ["real blocks", "every walker survives",
                                  "no walker survives"])
def test_end_table_caps_equal_single_sweep_and_jax(kind):
    buf, n, L = _stream(kind)
    st = _u8(buf)
    E0 = DS.end_table(st, n, L)
    np.testing.assert_array_equal(E0.numpy(), _jax_table(buf, n, L))
    budget = K._walk_units(L)
    for cap in (1, 4, 12, budget - 1, budget, 1000):
        E = DS.end_table(st, n, L, cap=cap)
        assert E.dtype == torch.int32 and E.shape == (len(buf) + 2,)
        assert torch.equal(E, E0), cap
        _, surv = K.scan_walk_capped(st, n, L, cap)
        if cap >= budget:
            assert surv is None
            continue
        k = int(surv.n[0])
        if kind == "every walker survives":
            # all but the walkers the stream's end stops within the cap
            assert k == len(buf) - cap + 1, cap
        elif kind == "no walker survives":
            assert k == 0, cap
        else:
            assert k < len(buf) and (k > 0 or cap > 12), cap
