"""jpeg_tpu_torch's two-sweep boundary scan (kernel K6',
``ops/kernels.py:scan_walk_resume``; ``device_scan.end_table(cap=)``) vs
jpeg_tpu.

On the CPU the wrapper runs its plain PyTorch version (the CUDA kernel runs
only on a GPU, where chip_smoke.py holds it against the plain version).
Every check is exact:

* The capped walkers (``c0 = w0 = 0``, cap 4 and 12) return the lengths,
  consumed bits and coefficient indices of the Pallas ``scan_walk_rows``
  two-sweep form in interpret mode, on inputs built as
  ``device_scan._walker_table_pallas`` builds them.
* Resuming the walkers still live at the cap gives the single sweep's
  lengths, and ``end_table(cap=c)`` is ``end_table(cap=0)`` and the JAX
  package's XLA end table, bit for bit, on valid, mutated and garbage
  streams.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_tpu.entropy import device_codec as JDC
from jpeg_tpu.entropy import device_scan as JDS
from jpeg_tpu.ops import pallas_kernels as PK

from jpeg_tpu_torch.entropy import device_scan as DS
from jpeg_tpu_torch.entropy import numpy_codec as NC
from jpeg_tpu_torch.ops import kernels as K

torch.set_num_threads(2)


def _stream(kind: str, L: int):
    """(bytes buffer, true length) of a few hundred bytes."""
    rng = np.random.default_rng(len(kind) * 100 + L)
    if kind == "garbage":
        buf = rng.integers(0, 256, 400, dtype=np.uint8).tobytes()
        return buf, len(buf) - 9
    if kind == "chains":             # 0xF0 runs past the unit budget
        buf = bytearray(rng.integers(0, 256, 300, dtype=np.uint8).tobytes())
        buf[40:200] = b"\xf0" * 160
        buf[200] = 0
        return bytes(buf), len(buf)
    n = 40
    lv = np.where(rng.random((n, L)) < 0.12,
                  rng.integers(-900, 901, (n, L)), 0).astype(np.int32)
    lv[3, L - 1] = 5                 # the longest run
    data = bytearray(NC.encode_levels(lv))
    if kind == "mutated":
        for i in rng.integers(0, len(data), 6):
            data[i] ^= 1 << int(rng.integers(8))
    return bytes(data) + bytes(7), len(data)


KINDS = ["valid", "mutated", "garbage"]


def _pallas_walkers(buf: bytes, n_bytes: int, L: int, cap: int):
    """jpeg_tpu's two-sweep walker in interpret mode, over every byte, with
    the rows, phases and remaining bits of ``_walker_table_pallas``."""
    P = len(buf)
    arr = np.frombuffer(buf, np.uint8)
    G, we, _ = JDS._scan_geometry(L)
    gb = 4 * G
    nw = (P // gb + 2) * G
    tbl = JDC._be_word_table(jnp.asarray(arr), P, nw).reshape(-1, G)
    tbl_ov = jnp.concatenate([tbl[:-1], tbl[1:]], axis=1)
    q = jnp.arange(P, dtype=jnp.int32)
    rows = tbl_ov[q // gb]
    phase = ((q % gb) * 8)[:, None]
    rem = (jnp.int32(8 * n_bytes) - q * 8)[:, None]
    return [np.asarray(x) for x in PK.scan_walk_rows(
        rows, phase, rem, L, weff=we, cap=cap, interpret=True)]


def _u8(buf: bytes) -> torch.Tensor:
    return torch.frombuffer(bytearray(buf), dtype=torch.uint8)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("cap", [4, 12])
def test_capped_walkers_equal_pallas_interpret(kind, cap):
    L = 64
    buf, n = _stream(kind, L)
    want = _pallas_walkers(buf, n, L, cap)
    P = len(buf)
    got = K.scan_walk_resume(_u8(buf), n, L, torch.arange(P), cap)
    for name, g, w in zip(("lengths", "bits", "indices"), got, want):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    if kind != "garbage":                # garbage walkers all settle early
        assert (got[0] == -2).any()      # the cap bites


@pytest.mark.parametrize("kind", KINDS + ["chains"])
@pytest.mark.parametrize("L", [16, 64])
def test_end_table_two_sweeps_equal_one(kind, L):
    buf, n = _stream(kind, L)
    P = len(buf)
    st = _u8(buf)
    E0 = DS.end_table(st, n, L)
    want = np.asarray(JDS._end_table_xla(
        jnp.asarray(np.frombuffer(buf, np.uint8)), P, jnp.int32(8 * n), L))
    np.testing.assert_array_equal(E0.numpy(), want)
    budget = L + L // 15 + 2
    for cap in (1, 4, 12, budget - 1, budget, 1000):
        E = DS.end_table(st, n, L, cap=cap)
        assert E.dtype == torch.int32 and E.shape == (P + 2,)
        assert torch.equal(E, E0), cap
        assert torch.equal(DS.end_table_two_sweep(st, n, L, cap), E0), cap


def test_resume_continues_where_the_cap_stopped():
    """Capped at 3 units, then the -2 walkers resumed from their carried
    (bits, index) in a second launch: the single sweep's lengths, bits and
    indices; walkers past n_live return (-2, c0, w0) untouched."""
    L = 64
    buf, n = _stream("valid", L)
    P = len(buf)
    st, q = _u8(buf), torch.arange(P)
    one = K.scan_walk_resume(st, n, L, q, 0)
    l1, c1, w1 = K.scan_walk_resume(st, n, L, q, 3)
    live = l1 == -2
    assert live.any() and (l1[~live] == one[0][~live]).all()
    ql = q[live]
    got = K.scan_walk_resume(st, n, L, ql, L + L // 15 + 2 - 3, c1[live],
                             w1[live])
    for g, w in zip(got, one):
        assert torch.equal(g, w[live])
    k = int(live.sum()) // 2
    part = K.scan_walk_resume(st, n, L, ql, 1000, c1[live], w1[live],
                              n_live=torch.tensor([k]))
    assert torch.equal(part[0][:k], got[0][:k])
    assert (part[0][k:] == -2).all()
    assert torch.equal(part[1][k:], c1[live][k:])
    assert torch.equal(part[2][k:], w1[live][k:])


def test_past_the_end_walkers_fail_at_once():
    """A walker at or past the true length fails with no bits consumed, as
    the Pallas walker's rem <= 0 rule says."""
    buf, n = _stream("valid", 16)
    P = len(buf)
    q = torch.tensor([n, n + 1, P - 1, P], dtype=torch.int64)
    length, c, w = K.scan_walk_resume(_u8(buf), n, 16, q, 5,
                                      torch.full((4,), 3, dtype=torch.int32),
                                      torch.full((4,), 2, dtype=torch.int32))
    assert length.tolist() == [-1] * 4
    assert c.tolist() == [3] * 4 and w.tolist() == [2] * 4


def test_resume_wrapper_checks_inputs():
    st = torch.zeros(8, dtype=torch.uint8)
    q = torch.arange(8)
    with pytest.raises(ValueError, match="int64"):
        K.scan_walk_resume(st, 8, 16, q.to(torch.int32), 4)
    with pytest.raises(ValueError, match="n_bytes"):
        K.scan_walk_resume(st, 9, 16, q, 4)
    with pytest.raises(ValueError, match="cap"):
        K.scan_walk_resume(st, 8, 16, q, -1)
    with pytest.raises(ValueError, match="c0"):
        K.scan_walk_resume(st, 8, 16, q, 4, torch.zeros(7, dtype=torch.int32))
    with pytest.raises(ValueError, match="one count"):
        K.scan_walk_resume(st, 8, 16, q, 4, n_live=torch.tensor([1, 2]))
    with pytest.raises(ValueError, match="different devices"):
        K.scan_walk_resume(st, 8, 16, q.to("meta"), 4)
    with pytest.raises(ValueError, match="cap"):
        DS.end_table(st, 8, 16, cap=-2)
    before = K.launch_counts()
    DS.end_table(st, 8, 16, cap=4)
    assert K.launch_counts() == before      # the plain version launches nothing
