"""jpeg_tpu_torch device boundary scan (entropy/device_scan.py; kernels
K6-K8) vs jpeg_tpu, mirroring tests/test_device_scan.py.

On the CPU each kernel wrapper runs its plain PyTorch version (the CUDA
kernels run only on a GPU, where chip_smoke.py holds each against its plain
version).  Tolerances:

* K6's end table is exact: it must equal ``jpeg_tpu``'s XLA walker
  (``device_scan._end_table_xla``) on the same padded buffer, and the Pallas
  walker in interpret mode on one small stream.
* K7 / K8 starts and ok are exact: they must equal ``jpeg_tpu``'s orbit
  chase (``_orbit_starts``, ``scan_bands_starts``, and the Pallas chase in
  interpret mode) and the host scanners.
* Host-free planes (``device="cpu"``) equal the port's host-scan planes
  exactly, and ``jpeg_tpu``'s f32 planes except +-1 at provable ties.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jpeg_tpu
import jpeg_tpu.container as jcontainer
import jpeg_tpu.entropy as jentropy
from jpeg_tpu.entropy import device_codec as JDC
from jpeg_tpu.entropy import device_scan as JDS
from jpeg_tpu.entropy import numpy_codec as JNC
from jpeg_tpu.ops import pallas_kernels as PK
from jpeg_tpu.utils import parity as jparity

import jpeg_tpu_torch
import jpeg_tpu_torch.entropy as entropy
from jpeg_tpu_torch import api
from jpeg_tpu_torch.config import BadRleCodeError, BadStreamError
from jpeg_tpu_torch.entropy import device_scan as DS
from jpeg_tpu_torch.entropy import numpy_codec as NC
from jpeg_tpu_torch.ops import kernels as K

torch.set_num_threads(2)


def _rand_levels(rng, n, L, density=0.15, amp=900):
    levels = np.zeros((n, L), dtype=np.int32)
    mask = rng.random((n, L)) < density
    levels[mask] = rng.integers(-amp, amp + 1, size=int(mask.sum()))
    return levels


def _u8(data: bytes) -> torch.Tensor:
    return torch.tensor(list(data), dtype=torch.uint8)


def _jax_end_table(data: bytes, P: int, L: int) -> np.ndarray:
    """jpeg_tpu's XLA walker on ``data`` zero-padded to P bytes."""
    arr = np.zeros(P, np.uint8)
    arr[:len(data)] = np.frombuffer(data, np.uint8)
    return np.asarray(JDS._end_table_xla(jnp.asarray(arr), P,
                                         jnp.int32(8 * len(data)), L))


def _port_end_table(data: bytes, P: int, L: int) -> np.ndarray:
    buf = bytes(data) + bytes(P - len(data))
    return K.scan_walk(_u8(buf), len(data), L).numpy()


@pytest.mark.parametrize("n,L,density", [
    (1, 64, 0.2), (37, 64, 0.05), (64, 16, 0.5), (9, 256, 0.02),
    (200, 64, 0.0),      # all-EOB stream: 1-byte blocks
    (5, 1, 0.5),         # dct_size=1: single-coefficient blocks
])
def test_matches_host_scan(n, L, density):
    rng = np.random.default_rng(n * 1000 + L)
    data = NC.encode_levels(_rand_levels(rng, n, L, density))
    starts, ok = DS.scan_offsets_device(data, n, L, device="cpu")
    assert ok
    assert np.array_equal(starts, JNC.scan_offsets(data, n, L))
    assert starts.dtype == np.int32
    # the plain K6 table equals the JAX walker's on a zero-padded buffer
    np.testing.assert_array_equal(_port_end_table(data, len(data) + 13, L),
                                  _jax_end_table(data, len(data) + 13, L))


def test_chains_and_extremes():
    # >15-zero runs (chain units), run%15==0 quirk (reference util.py:149-154),
    # max-amplitude codes, trailing-zeros blocks.
    L = 64
    lv = np.zeros((6, L), np.int32)
    lv[0, 63] = 1            # 63 zeros: 4 chains + code
    lv[1, 15] = -5           # run exactly 15: chain + (0,size,amp)
    lv[2, 30] = 16383        # max representable |amp|
    lv[3, :] = -1            # dense block
    lv[4, 0] = 3             # leading code, rest zeros -> immediate EOB
    data = NC.encode_levels(lv)
    starts, ok = DS.scan_offsets_device(data, 6, L, device="cpu")
    assert ok
    assert np.array_equal(starts, JNC.scan_offsets(data, 6, L))
    np.testing.assert_array_equal(_port_end_table(data, len(data), L),
                                  _jax_end_table(data, len(data), L))


def test_rejects_malformed_streams():
    data = NC.encode_levels(np.ones((4, 16), np.int32))
    bad_cases = [
        data[:-1],               # truncated tail
        data[:1],                # truncated mid-block
        data + b"\x00",          # trailing bytes
        data + data,             # trailing blocks
        b"\xff" * 16,            # bad (15, 15) wandering garbage
        b"\x70" * 4,             # (7, 0) invalid code
        b"",                     # empty
    ]
    for bad in bad_cases:
        _, ok = DS.scan_offsets_device(bytes(bad), 4, 16, device="cpu")
        assert not ok, bad[:8]
    for bad in (data[:-1], b"\xff" * 16, b"\x70" * 4):
        np.testing.assert_array_equal(_port_end_table(bad, 96, 16),
                                      _jax_end_table(bad, 96, 16))


def test_rejects_coefficient_overflow():
    # A stream whose codes index past L for the declared geometry: encode
    # with L=64, scan claiming L=16.
    lv = np.zeros((1, 64), np.int32)
    lv[0, 40] = 9
    data = NC.encode_levels(lv)
    _, ok = DS.scan_offsets_device(data, 1, 16, device="cpu")
    assert not ok
    with pytest.raises(BadStreamError):
        NC.scan_offsets(data, 1, 16)


def test_hybrid_raises_host_errors():
    data = NC.encode_levels(np.ones((4, 16), np.int32))
    with pytest.raises(BadStreamError):
        DS.scan_offsets_hybrid(data[:-1], 4, 16, device="cpu")
    with pytest.raises(BadStreamError):
        DS.scan_offsets_hybrid(data + b"\x00", 4, 16, device="cpu")
    with pytest.raises(BadRleCodeError):
        DS.scan_offsets_hybrid(b"\x70\x00\x00\x00", 4, 16, device="cpu")
    # valid stream passes through bit-exactly, without a warning
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert np.array_equal(
            DS.scan_offsets_hybrid(data, 4, 16, device="cpu"),
            NC.scan_offsets(data, 4, 16))


def test_hybrid_warns_when_only_the_device_rejects(monkeypatch):
    """If the device check ever fails on a stream the host accepts, the
    hybrid returns the host's starts with a RuntimeWarning."""
    data = NC.encode_levels(np.ones((4, 16), np.int32))
    monkeypatch.setattr(DS, "scan_offsets_device",
                        lambda *a, **k: (np.zeros(4, np.int32), False))
    with pytest.warns(RuntimeWarning, match="device scan rejected"):
        got = DS.scan_offsets_hybrid(data, 4, 16, device="cpu")
    assert np.array_equal(got, NC.scan_offsets(data, 4, 16))


def test_fuzz_three_way():
    """Differential: the port's device scan vs jpeg_tpu's NumPy scanner vs
    the port's native scanner, on random and single-byte-mutated streams,
    plus entropy.scan_offsets with scan="device"."""
    rng = np.random.default_rng(42)
    for trial in range(30):
        n = int(rng.integers(1, 40))
        L = int(rng.choice([16, 64]))
        data = NC.encode_levels(
            _rand_levels(rng, n, L, float(rng.uniform(0, 0.4))))
        ref = JNC.scan_offsets(data, n, L)
        got, ok = DS.scan_offsets_device(data, n, L, device="cpu")
        assert ok and np.array_equal(got, ref), trial
        assert np.array_equal(entropy.scan_offsets(data, n, L), ref)
        assert np.array_equal(
            entropy.scan_offsets(data, n, L, scan="device", device="cpu"),
            ref)

        # single-byte mutation: every side must agree on accept/reject,
        # and on the starts when they accept
        mut = bytearray(data)
        i = int(rng.integers(len(mut)))
        mut[i] ^= 1 << int(rng.integers(8))
        mut = bytes(mut)
        try:
            ref_m = JNC.scan_offsets(mut, n, L)
            host_ok = True
        except (jpeg_tpu.config.BadStreamError,
                jpeg_tpu.config.BadRleCodeError):
            host_ok = False
        got_m, dev_ok = DS.scan_offsets_device(mut, n, L, device="cpu")
        assert dev_ok == host_ok, (trial, i)
        try:
            nat_m = entropy.scan_offsets(mut, n, L, scan="host")
            assert host_ok and np.array_equal(nat_m, ref_m), (trial, i)
        except (BadStreamError, BadRleCodeError):
            assert not host_ok, (trial, i)
        if host_ok:
            assert np.array_equal(got_m, ref_m), (trial, i)


def test_pallas_walker_and_chase_in_interpret_mode(monkeypatch):
    """The Mosaic walker (K6) and chase (K7) in interpret mode on one small
    stream: the same end table and starts as the port's plain versions."""
    monkeypatch.setenv("JPEG_TPU_PALLAS", "interpret")
    rng = np.random.default_rng(1037)
    L, n = 64, 37
    data = NC.encode_levels(_rand_levels(rng, n, L, 0.05))
    P = (len(data) + 8) & ~3           # host_stream_arg takes whole words
    arr = np.zeros(P, np.uint8)
    arr[:len(data)] = np.frombuffer(data, np.uint8)
    E_jax, err = JDS._end_table(jnp.asarray(JDC.host_stream_arg(arr)),
                                jnp.int32(len(data)), L)
    E = K.scan_walk(_u8(arr.tobytes()), len(data), L)
    assert int(err) == P + 1
    np.testing.assert_array_equal(E.numpy(), np.asarray(E_jax))
    starts_jax, ok_jax = PK.chase_starts(E_jax, jnp.int32(len(data)), n,
                                         interpret=True)
    starts, ok = DS.orbit_starts(E, len(data), n)
    assert bool(ok) and bool(ok_jax)
    np.testing.assert_array_equal(starts.numpy(), np.asarray(starts_jax))
    np.testing.assert_array_equal(starts.numpy(),
                                  JNC.scan_offsets(data, n, L))


def _serial_chase(E, target, s0, nb):
    """The chase's definition, one step at a time."""
    P2 = len(E)
    starts, pos = [], s0
    for _ in range(nb):
        starts.append(pos)
        pos = int(E[min(max(pos, 0), P2 - 1)])
    return starts, pos == target


@pytest.mark.parametrize("nb", [0, 1, 2, 3, 7, 8, 100])
def test_chase_plain_equals_the_serial_chase(nb):
    """Pointer doubling (the plain K7 / K8) gives the serial chase's starts
    and ok on random tables, out-of-range chain starts included."""
    rng = np.random.default_rng(nb)
    P2 = 50
    E = rng.integers(0, P2, P2).astype(np.int32)
    s0s = [0, 3, 49, 77, -4]
    targets = [_serial_chase(E, -1, s0, nb + 1)[0][-1] for s0 in s0s]
    targets[1] += 1                                  # one chain misses
    starts, ok = K.chase_starts_multi(
        torch.from_numpy(E), torch.tensor(targets), torch.tensor(s0s), nb)
    assert starts.shape == (len(s0s), nb) and starts.dtype == torch.int64
    for b, (s0, t) in enumerate(zip(s0s, targets)):
        want, want_ok = _serial_chase(E, t, s0, nb)
        assert starts[b].tolist() == want
        assert bool(ok[b]) == want_ok
        one, one_ok = K.chase_starts(torch.from_numpy(E), t, s0, nb)
        assert one.tolist() == want and bool(one_ok) == want_ok


def test_scan_bands_starts_multiband(monkeypatch):
    """One walker table over a 3-band concatenated buffer + three orbit
    chases (the host-free decode's scan): starts match the per-band host
    scans and jpeg_tpu's scan_bands_starts (and its Pallas chase in
    interpret mode), and a truncated middle band fails the check."""
    rng = np.random.default_rng(11)
    L, nb = 64, 9
    bands = [NC.encode_levels(_rand_levels(rng, nb, L, d))
             for d in (0.1, 0.3, 0.0)]

    def run(bands_bytes):
        buf = b"".join(bands_bytes)
        ends = np.cumsum([len(b) for b in bands_bytes])
        starts, ok = DS.scan_bands_starts(_u8(buf), ends, nb, L)
        jstarts, jok = JDS.scan_bands_starts(
            jnp.asarray(np.frombuffer(buf, np.uint8)),
            jnp.asarray(ends.astype(np.int32)), nb, L)
        assert bool(ok) == bool(jok)
        if bool(ok):
            np.testing.assert_array_equal(starts.numpy(), np.asarray(jstarts))
        return starts.numpy(), bool(ok), buf, ends

    starts, ok, buf, ends = run(bands)
    assert ok
    offs = np.cumsum([0, len(bands[0]), len(bands[1])])
    want = np.concatenate([NC.scan_offsets(b, nb, L) + o
                           for b, o in zip(bands, offs)])
    assert np.array_equal(starts, want)
    E = K.scan_walk(_u8(buf), len(buf), L)
    s0s = np.concatenate([[0], ends[:-1]]).astype(np.int32)
    jstarts, joks = PK.chase_starts_multi(
        jnp.asarray(E.numpy()), jnp.asarray(ends.astype(np.int32)),
        jnp.asarray(s0s), nb, interpret=True)
    np.testing.assert_array_equal(np.asarray(jstarts).reshape(-1), want)
    assert np.asarray(joks).all()

    # Truncating the MIDDLE band shifts band 2's start: its orbit (and/or
    # band 1's end check) must fail even though the bytes parse locally.
    _, ok_bad, _, _ = run([bands[0], bands[1][:-1], bands[2]])
    assert not ok_bad


def test_scan_mode_policy(monkeypatch):
    assert DS.scan_mode(10, "device") == "device"
    assert DS.scan_mode(10, "device", device="cpu") == "device"
    assert DS.scan_mode(1 << 30, "host") == "host"
    with pytest.raises(ValueError, match="scan must be one of"):
        DS.scan_mode(10, "fast")
    # auto: always host on the CPU; host whenever the C++ scanner exists;
    # device only without it and past the measured threshold
    assert DS.scan_mode(1 << 30, "auto", device="cpu") == "host"
    assert entropy._get_native() is not None
    assert DS.scan_mode(1 << 30, "auto", device="cuda") == "host"
    monkeypatch.setattr(entropy, "_native", None)
    monkeypatch.setattr(entropy, "_native_checked", True)
    assert DS.scan_mode(DS.PY_SCAN_DEVICE_MIN_BYTES, device="cuda") == \
        "device"
    assert DS.scan_mode(DS.PY_SCAN_DEVICE_MIN_BYTES - 1, device="cuda") == \
        "host"
    assert DS.scan_mode(1 << 30, device="cpu") == "host"
    # entropy.scan_offsets follows the policy: the pure-Python scanner
    # without the C++ one, the device scan when asked
    data = NC.encode_levels(np.ones((4, 16), np.int32))
    assert np.array_equal(entropy.scan_offsets(data, 4, 16, device="cpu"),
                          NC.scan_offsets(data, 4, 16))
    with pytest.raises(BadStreamError):
        entropy.scan_offsets(data[:-1], 4, 16, scan="device", device="cpu")


def _cfgs(h, w, qname):
    q = {} if qname != "divide" else {"divisor": 50}
    return (jpeg_tpu_torch.Configuration(
                width=w, height=h, block_size=2,
                quantization=jpeg_tpu_torch.QuantizationMethod(qname, **q)),
            jpeg_tpu.Configuration(
                width=w, height=h, block_size=2,
                quantization=jpeg_tpu.QuantizationMethod(qname, **q)))


def _assert_jax_planes_except_ties(rec, blob):
    """(H, W, 3) planes vs jpeg_tpu's f32 decode: equal except +-1 at
    provable ties."""
    want = jpeg_tpu.decompress_to_ycbcr(blob, dtype=np.float32)
    jcfg, data = jcontainer.read_data(blob)
    L = jcfg.dct_size ** 2
    for b, s in enumerate((data.y, data.cb, data.cr)):
        lv = jentropy.decode_levels(s, jcfg.num_blocks, L)
        _, ties = jparity.decode_reference_and_ties(jcfg, lv)
        jparity.assert_tie_equal(rec[:, :, b], want[:, :, b], ties,
                                 f"band {b}")


def test_long_block_decode_host_free():
    """quantization="none" gives long blocks (a garbage walker's worst case
    is near them): the host-free planes equal the host-scan planes exactly,
    and jpeg_tpu's except at ties; a malformed body raises the host path's
    error."""
    tcfg, jcfg = _cfgs(24, 40, "none")
    img = np.random.default_rng(5).integers(0, 256, (24, 40, 3), np.uint8)
    blob = jpeg_tpu.compress_ycbcr(img, jcfg, dtype=np.float32)
    base = jpeg_tpu_torch.decompress_to_ycbcr(blob, device="cpu",
                                              scan="host")
    K.reset_launch_counts()
    got = jpeg_tpu_torch.decompress_to_ycbcr(blob, device="cpu",
                                             scan="device")
    assert set(K.launch_counts().values()) == {0}   # plain versions only
    np.testing.assert_array_equal(got, base)
    _assert_jax_planes_except_ties(got, blob)
    _, data = jcontainer.read_data(blob)
    assert max(np.diff(NC.scan_offsets(data.y, jcfg.num_blocks, 64))) > 46
    for bad in (blob[:-3], blob[:-1] + b"\xff"):
        with pytest.raises(BadStreamError):
            jpeg_tpu_torch.decompress_to_ycbcr(bad, device="cpu",
                                               scan="host")
        with pytest.raises(BadStreamError):
            jpeg_tpu_torch.decompress_to_ycbcr(bad, device="cpu",
                                               scan="device")


def test_foreign_decode_raises_when_only_the_device_rejects(monkeypatch):
    """If the device check ever fails on a stream the host accepts, the
    host-free decode raises instead of decoding through the host scan."""
    tcfg, jcfg = _cfgs(24, 40, "qtable")
    img = np.random.default_rng(9).integers(0, 256, (24, 40, 3), np.uint8)
    blob = jpeg_tpu.compress_ycbcr(img, jcfg, dtype=np.float32)
    scan = DS.scan_bands_starts
    monkeypatch.setattr(
        DS, "scan_bands_starts",
        lambda *a: (scan(*a)[0], torch.tensor(False)))
    with pytest.raises(RuntimeError, match="device scan rejected"):
        jpeg_tpu_torch.decompress_to_ycbcr(blob, device="cpu", scan="device")
    with pytest.raises(RuntimeError, match="device scan rejected"):
        jpeg_tpu_torch.decompress_many([blob], device="cpu", scan="device")
    # a malformed stream still raises the host scanner's error
    with pytest.raises(BadStreamError):
        jpeg_tpu_torch.decompress_to_ycbcr(blob[:-3], device="cpu",
                                           scan="device")


def test_foreign_decode_deferred_through_decompress_many():
    """The decode returns a deferred resolver under either scan (the
    device scan's check is read at pull time); decompress_many must resolve
    it in its puller and give images identical to the host-scan path, in
    order."""
    tcfg, jcfg = _cfgs(24, 40, "qtable")
    rng = np.random.default_rng(8)
    imgs = [rng.integers(0, 256, (24, 40, 3), np.uint8) for _ in range(3)]
    blobs = [jpeg_tpu.compress_ycbcr(im, jcfg, dtype=np.float32)
             for im in imgs]
    res = api._start_decompress(blobs[0], torch.device("cpu"), "device")
    assert callable(res)
    host = api._start_decompress(blobs[0], torch.device("cpu"), "host")
    assert callable(host)
    assert torch.equal(res(), host())
    base = jpeg_tpu_torch.decompress_many(blobs, device="cpu", scan="host")
    got = jpeg_tpu_torch.decompress_many(blobs + blobs[:1], device="cpu",
                                         scan="device")
    assert len(got) == 4
    for g, b, blob in zip(got, base + base[:1], blobs + blobs[:1]):
        np.testing.assert_array_equal(g, b)
        _assert_jax_planes_except_ties(g, blob)
