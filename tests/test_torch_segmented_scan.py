"""The segmented boundary scan (kernel K10, ``csrc/segment_scan.cu``) held
against K6 + K8 on the CPU.

* ``kernels.segment_scan_plain`` (the plain version, which the CPU's
  device scan runs) against the plain ``device_scan.scan_bands_starts``
  (K6's table and K8's chase): the same check everywhere and the same
  starts where it holds, on the ``photo24mp_444`` configuration's tiny
  frame and on 240 x 320 frames over several seeds, at segment lengths
  under a block, cut exactly on a true start, of one segment a band and of
  hundreds a band; and on malformed bands: truncated, bits flipped, bytes
  overwritten, a last block run into the next band's length field, a band
  a byte short, more bands than one launch takes.
* The engage rule: a decode with ``SEGMENTED_MIN_BLOCKS`` blocks a band or
  more takes it and counts ``scan.segmented``, ``scan.segments`` and
  ``scan.segments_unsynced`` (the last read only while recording); below,
  K6 + K8 run as before.  A rejected band raises the host scanner's
  error.
* The wrapper's checks and the constants it shares with the source.
"""
import inspect
import os
import re
import sys

import numpy as np
import pytest
import torch

import jpeg_tpu_torch as J
from jpeg_tpu_torch import container
from jpeg_tpu_torch.entropy import device_scan as DS
from jpeg_tpu_torch.ops import kernels as K
from jpeg_tpu_torch.utils import profiling as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from port_bench.frames import synth_frames  # noqa: E402
from port_bench.reference import codec as R  # noqa: E402

PHOTO = {"block_size": 1, "dct_size": 8, "transform": "DCT",
         "quantization": {"name": "qtable", "params": {}}}
L = 64


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain scans run thousands of small torch ops: one thread each,
    so that parallel test workers do not contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _blob(h, w, seed):
    codec = R.Codec.from_settings(PHOTO, h, w)
    frame = synth_frames(1, h, w, seed, "cpu")[0]
    return R.encode_container(codec, frame)


def _bands(blob):
    """A container's bands as a decode moves them: (stream bytes from the
    first band's first byte to the last band's end, firsts, ends, blocks a
    band)."""
    config, spans = container.read_band_spans(blob)
    base = spans[0][0]
    firsts = [pos - base for pos, _ in spans]
    ends = [first + n for first, (_, n) in zip(firsts, spans)]
    return (bytes(blob[base:base + ends[-1]]), firsts, ends,
            config.num_blocks)


def _u8(data):
    return torch.frombuffer(bytearray(data), dtype=torch.uint8)


def _k6k8(data, firsts, ends, nb):
    starts, ok = DS.scan_bands_starts(_u8(data), ends, nb, L, firsts)
    return starts, bool(ok)


def _k10(data, firsts, ends, nb, seg):
    starts, status = K.segment_scan(_u8(data), firsts, ends, nb, L, seg)
    assert status.dtype == torch.int32 and status.shape == (2,)
    return starts, int(status[0]) == 0, int(status[1])


def _same(data, firsts, ends, nb, seg):
    """K10 at ``seg`` against K6 + K8: the same check, the same starts
    where it holds.  Returns (the check, K10's unsynced walkers)."""
    want, ok = _k6k8(data, firsts, ends, nb)
    got, held, unsynced = _k10(data, firsts, ends, nb, seg)
    assert held == ok
    if ok:
        assert torch.equal(got, want)
    assert got.shape == (len(firsts) * nb,)
    return ok, unsynced


@pytest.fixture(scope="module")
def tiny():
    return _bands(_blob(44, 60, 2 ** 31 + 25))


@pytest.fixture(scope="module")
def mid():
    return _bands(_blob(240, 320, 3_250_000_001))


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 7, 3_250_000_002])
@pytest.mark.parametrize("seg", [32, 64, 256, K.SEGMENT_BYTES, 1 << 20])
def test_tiny_frame_equal_to_k6_k8(seed, seg):
    data, firsts, ends, nb = _bands(_blob(44, 60, seed))
    assert nb == 48
    ok, _ = _same(data, firsts, ends, nb, seg)
    assert ok


@pytest.mark.parametrize("seed", [5, 2 ** 33 + 1])
@pytest.mark.parametrize("seg", [32, 96, K.SEGMENT_BYTES, 4096])
def test_240x320_equal_to_k6_k8(seed, seg):
    data, firsts, ends, nb = _bands(_blob(240, 320, seed))
    assert nb == 1200
    ok, _ = _same(data, firsts, ends, nb, seg)
    assert ok


def test_segments_shorter_than_a_block_unsync_and_still_agree(mid):
    """At 32 bytes a segment most blocks span several segments: walkers
    jump segments (unsynced), and the exact walk is still K8's."""
    data, firsts, ends, nb = mid
    ok, unsynced = _same(data, firsts, ends, nb, 32)
    assert ok and unsynced > 100
    assert (ends[0] - firsts[0]) / nb > 32            # longer than a cut


def test_hundreds_of_segments_a_band(mid):
    data, firsts, ends, nb = mid
    seg = 64
    counts = K.segment_counts(firsts, ends, seg)
    assert min(counts) >= 300
    ok, _ = _same(data, firsts, ends, nb, seg)
    assert ok


def test_one_segment_a_band(mid):
    data, firsts, ends, nb = mid
    seg = -(-max(e - f for f, e in zip(firsts, ends)) // 32) * 32
    assert K.segment_counts(firsts, ends, seg) == [1, 1, 1]
    ok, unsynced = _same(data, firsts, ends, nb, seg)
    assert ok and unsynced == 0


@pytest.mark.parametrize("band", [0, 1, 2])
def test_a_cut_exactly_on_a_true_start(mid, band):
    """A segment length that puts a cut on a true block start of the band
    (a start 32 x m bytes into it): that walker starts exact."""
    data, firsts, ends, nb = mid
    starts, ok = _k6k8(data, firsts, ends, nb)
    assert ok
    own = starts[band * nb:(band + 1) * nb] - firsts[band]
    on = [int(s) for s in own if s > 0 and s % 32 == 0]
    seg = on[len(on) // 2]
    assert int(seg) in {int(s) for s in own}
    ok, _ = _same(data, firsts, ends, nb, seg)
    assert ok


def _flip(data, pos, mask):
    b = bytearray(data)
    b[pos] ^= mask
    return bytes(b)


def _malformed(data, firsts, ends, seed):
    """(name, bytes, ends) of malformed copies of the bands."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(3):
        f, e = firsts[b], ends[b]
        short = list(ends)
        short[b] -= 1
        out.append((f"band {b} a byte short", data, short))
        cut = list(ends)
        cut[b] = f + (e - f) // 2
        out.append((f"band {b} cut in half", data, cut))
        for i in range(3):
            pos = int(rng.integers(f, e))
            out.append((f"band {b} bit flip {i}",
                        _flip(data, pos, 1 << int(rng.integers(8))), ends))
        junk = bytearray(data)
        pos = int(rng.integers(f, e - 24))
        junk[pos:pos + 24] = bytes(rng.integers(0, 256, 24).tolist())
        out.append((f"band {b} bytes overwritten", bytes(junk), ends))
        out.append((f"band {b} first byte garbled", _flip(data, f, 0x5A),
                    ends))
        if b < 2:
            long = list(ends)
            long[b] += 2                 # into the next band's u32 length
            out.append((f"band {b} into the next length field", data, long))
    truncated = list(ends)
    truncated[2] = len(data) - 3
    out.append(("stream truncated", data[:len(data) - 3], truncated))
    return out


@pytest.mark.parametrize("seg", [32, 64, K.SEGMENT_BYTES, 1 << 20])
def test_malformed_bands_give_k6_k8s_check(mid, seg):
    data, firsts, ends, nb = mid
    cases = _malformed(data, firsts, ends, seed=seg)
    assert len(cases) >= 20
    rejected = 0
    for name, d, e in cases:
        ok, _ = _same(d, firsts, e, nb, seg)
        rejected += not ok
    # a flipped magnitude bit may still parse: then the starts were equal
    assert rejected >= len(cases) // 2


@pytest.mark.parametrize("seg", [32, K.SEGMENT_BYTES])
def test_tiny_frame_malformed(tiny, seg):
    data, firsts, ends, nb = tiny
    for name, d, e in _malformed(data, firsts, ends, seed=7 + seg):
        _same(d, firsts, e, nb, seg)


def test_a_rejected_bands_starts_are_its_walk_then_its_end(mid):
    """A band cut in half: its starts are the exact walk's accepted
    positions, in order, then the band's end; the other bands' are K8's."""
    data, firsts, ends, nb = mid
    cut = list(ends)
    cut[1] = firsts[1] + (ends[1] - firsts[1]) // 2
    got, held, _ = _k10(data, firsts, cut, nb, 64)
    assert not held
    want, _ = _k6k8(data, firsts, ends, nb)
    band = got[nb:2 * nb]
    inside = band[band < cut[1]]
    assert torch.equal(inside, want[nb:nb + inside.numel()])
    assert bool((band[inside.numel():] == cut[1]).all())
    assert torch.equal(got[:nb], want[:nb])
    assert torch.equal(got[2 * nb:], want[2 * nb:])


def test_status_counts_faults_and_unsynced(mid):
    data, firsts, ends, nb = mid
    _, status = K.segment_scan(_u8(data), firsts, ends, nb, L, 1 << 20)
    assert status.tolist() == [0, 0]
    _, status = K.segment_scan(_u8(data), firsts, ends, nb + 1, L, 64)
    assert int(status[0]) >= 3                   # every band one short
    _, status = K.segment_scan(_u8(data), firsts, ends, nb, L, 32)
    assert int(status[0]) == 0 and int(status[1]) > 0


def test_more_bands_than_one_launch_takes(tiny):
    """SEGMENT_MAX_BANDS + 3 copies of a band, each behind a 4-byte length
    field as in a container."""
    data, firsts, ends, nb = tiny
    band = data[firsts[0]:ends[0]]
    B = K.SEGMENT_MAX_BANDS + 3
    buf, fs, es = b"", [], []
    for _ in range(B):
        buf += len(band).to_bytes(4, "little")
        fs.append(len(buf))
        buf += band
        es.append(len(buf))
    for seg in (32, K.SEGMENT_BYTES):
        ok, _ = _same(buf, fs, es, nb, seg)
        assert ok
    es[B - 2] -= 1
    ok, _ = _same(buf, fs, es, nb, 32)
    assert not ok


def test_empty_and_zero_block_bands():
    data = b"\x00" * 8
    for firsts, ends, nb, want in (([0], [0], 0, True), ([0], [0], 2, False),
                                   ([0], [8], 8, True), ([0], [8], 0, False),
                                   ([0, 4], [4, 8], 4, True)):
        starts, ok = _k6k8(data, firsts, ends, nb)
        assert ok == want
        got, held, _ = _k10(data, firsts, ends, nb, 32)
        assert held == want
        if want:
            assert torch.equal(got, starts)


def test_wrapper_checks_its_arguments():
    s = torch.zeros(16, dtype=torch.uint8)
    with pytest.raises(ValueError, match="multiple of 32"):
        K.segment_scan(s, [0], [16], 2, L, 48)
    with pytest.raises(ValueError, match="lie in"):
        K.segment_scan(s, [0], [17], 2, L, 32)
    with pytest.raises(ValueError, match="lie in"):
        K.segment_scan(s, [9], [8], 2, L, 32)
    with pytest.raises(ValueError, match="band starts"):
        K.segment_scan(s, [0, 8], [16], 2, L, 32)
    with pytest.raises(ValueError, match="L must be"):
        K.segment_scan(s, [0], [16], 2, 0, 32)
    with pytest.raises(ValueError, match="uint8"):
        K.segment_scan(s.to(torch.int32), [0], [16], 2, L, 32)
    before = K.launch_counts()
    K.segment_scan(s, [0], [16], 16, L, 32)
    assert K.launch_counts() == before   # the plain version launches nothing


def test_segment_length_plan():
    """One segment length for every stream, the wrapper's default."""
    assert K.SEGMENT_BYTES % 32 == 0
    default = inspect.signature(K.segment_scan).parameters["seg_bytes"]
    assert default.default == K.SEGMENT_BYTES


def test_scratch_layout():
    counts = K.segment_counts([0, 100, 5000], [100, 5000, 5000], 256)
    assert counts == [1, 20, 1]
    G, entries = K.segment_scratch(counts, 256)
    assert G == 3 * K.SEGMENT_THREADS
    assert entries == G * (13 + K.SEGMENT_KEPT + 8) + G // 16 + 3


def _source():
    with open(os.path.join(K.CSRC, "segment_scan.cu")) as f:
        return f.read()


def test_constants_and_entry_point_are_the_sources():
    src = _source()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert constant("kThreads") == K.SEGMENT_THREADS
    assert constant("kCont") == K.SEGMENT_KEPT
    assert constant("kMaxBands") == K.SEGMENT_MAX_BANDS
    params = re.search(r"JT_API int jt_segment_scan\((.*?)\)", src, re.S)[1]
    assert len(params.split(",")) == len(K._SIGNATURES["jt_segment_scan"])
    # the 13 arrays of one entry a walker slot, as segment_scratch counts
    slots = re.search(r"for \(int32_t\*\* a : \{(.*?)\}\)", src, re.S)[1]
    assert len(slots.split(",")) == 13
    # the walk is scan_walk.cuh's, shared with K6
    assert '#include "scan_walk.cuh"' in src
    assert "walk(rd, " in src and "int walk(" not in src


# ---------------------------------------------------------------------------
# The engage rule and the counters, through the decode on the CPU
# ---------------------------------------------------------------------------

def _recorded(blob, scan="device"):
    P.start_recording()
    try:
        planes = J.decompress_to_device(blob, device="cpu", scan=scan)
    finally:
        P.stop_recording()
    return planes, P.recorded().counts


@pytest.fixture(scope="module")
def long_bands():
    """264 x 256 at bs 1: 1,056 blocks a band, past SEGMENTED_MIN_BLOCKS."""
    return _blob(264, 256, 2 ** 32 + 25)


def test_segmented_threshold_is_past_k8s_short_form():
    assert DS.SEGMENTED_MIN_BLOCKS > K.CHASE_DIRECT_MAX
    assert not DS.segmented(K.CHASE_DIRECT_MAX)
    assert DS.segmented(DS.SEGMENTED_MIN_BLOCKS)


def test_long_bands_take_the_segmented_scan_and_count_it(long_bands,
                                                         monkeypatch):
    calls = []
    real = K.segment_scan

    def spy(*a, **k):
        calls.append(a)
        return real(*a, **k)
    monkeypatch.setattr(K, "segment_scan", spy)
    blob = long_bands
    data, firsts, ends, nb = _bands(blob)
    assert nb == 1056 and DS.segmented(nb)
    got, counts = _recorded(blob)
    assert len(calls) == 1
    assert counts["scan.segmented"] == 1
    assert counts["scan.segments"] == sum(
        K.segment_counts(firsts, ends, K.SEGMENT_BYTES))
    assert counts["scan.segments_unsynced"] >= 0
    want = J.decompress_to_device(blob, device="cpu", scan="host")
    assert torch.equal(got, want)


def test_unsynced_is_read_only_while_recording(long_bands, monkeypatch):
    reads = []
    real = DS.check_held

    def spy(ok):
        reads.append((ok.dim(), P.recording()))
        return real(ok)
    monkeypatch.setattr(DS, "check_held", spy)
    J.decompress_to_device(long_bands, device="cpu", scan="device")
    _, counts = _recorded(long_bands)
    assert reads == [(1, False), (1, True)]
    assert "scan.segments_unsynced" in counts


def test_short_bands_keep_k6_k8(monkeypatch):
    """1,024 blocks a band: K6 and K8's short form, nothing segmented."""
    blob = _blob(256, 256, 1024)
    monkeypatch.setattr(K, "segment_scan", None)    # must not be called
    _, counts = _recorded(blob)
    for name in ("scan.segmented", "scan.segments",
                 "scan.segments_unsynced"):
        assert name not in counts


def test_k8s_long_form_gives_the_same_planes(long_bands, monkeypatch):
    """With the threshold raised past the band, the same decode runs K6 and
    K8's long form, counts no segment counter, and gives the same
    planes."""
    plans = []
    real = K.chase_starts_multi

    def spy(E, targets, s0s, nb):
        plans.append(K.chase_plan(E.shape[0], targets.shape[0], nb))
        return real(E, targets, s0s, nb)
    monkeypatch.setattr(DS, "SEGMENTED_MIN_BLOCKS", 2000)
    monkeypatch.setattr(K, "chase_starts_multi", spy)
    got, counts = _recorded(long_bands)
    assert len(plans) == 1 and plans[0].anchors > 0
    assert "scan.segmented" not in counts and "scan.segments" not in counts
    monkeypatch.undo()
    want, counts = _recorded(long_bands)
    assert counts["scan.segmented"] == 1
    assert torch.equal(got, want)


def test_host_scan_counts_nothing_of_the_device_scan(long_bands):
    _, counts = _recorded(long_bands, scan="host")
    assert not {"scan.segmented", "scan.segments",
                "scan.segments_unsynced"} & set(counts)


@pytest.mark.parametrize("entry", ["decompress_to_device",
                                   "decompress_to_ycbcr", "decompress_many"])
def test_rejected_long_band_raises_the_host_scanners_error(long_bands,
                                                           entry):
    spans = container.read_band_spans(long_bands)[1]
    pos, n = spans[1]
    bad = bytearray(long_bands)
    bad[pos] = 0x70                              # run 7, size 0: no code
    bad = bytes(bad)

    def run(scan):
        fn = getattr(J, entry)
        try:
            fn([bad] if entry == "decompress_many" else bad, device="cpu",
               scan=scan)
        except Exception as e:                  # noqa: BLE001 - compared
            return type(e), str(e)
        return None

    want = run("host")
    assert want is not None and want[0] is not RuntimeError
    assert run("device") == want
