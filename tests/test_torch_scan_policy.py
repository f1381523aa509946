"""A decode's boundary-scan policy (``entropy.device_scan.decode_scan``,
read by ``api._start_decompress``).

* The rule's choices: on a CUDA device ``"auto"`` takes the device scan at
  every size, with or without the C++ scanner; on the CPU the host scan;
  an explicit ``"host"`` or ``"device"`` is honoured.
* ``entropy.scan_offsets``' ``"auto"``, whose starts go back to the host,
  keeps the host scanner whenever it is built.
* With the rule's CUDA branch taken on the CPU path (``decode_scan``
  patched to decide as for a CUDA device; the plain K6 / K8 versions run),
  the answers of ``decompress_to_ycbcr``, ``decompress_many`` and
  ``Jpeg.decompress`` at d 8 and d 24, down to one block of stream, equal
  ``scan="host"``'s bit for bit, and truncated or corrupted containers
  raise the host scan's exception with its message.
* ``scan.auto_device`` counts once per ``"auto"`` decode that takes the
  device scan, and never on an explicit ``scan=`` or on the CPU.
"""
import numpy as np
import pytest
import torch

import jpeg_tpu_torch as J
from jpeg_tpu_torch import entropy
from jpeg_tpu_torch.entropy import device_scan as DS
from jpeg_tpu_torch.entropy import native_codec as NC
from jpeg_tpu_torch.utils import profiling as P

torch.set_num_threads(2)

MANY = 3
ENTRIES = ("decompress_to_ycbcr", "decompress_many", "Jpeg.decompress")


def _config(d, width=None, height=None):
    if d == 8:
        return J.Configuration(width=width or 64, height=height or 40,
                               block_size=2, dct_size=8, transform="DCT",
                               quantization=J.QuantizationMethod("qtable"))
    return J.Configuration(width=width or 100, height=height or 60,
                           block_size=2, dct_size=24, transform="DCT",
                           quantization=J.QuantizationMethod(
                               "divide", divisor=50))


def _image(cfg, seed):
    y, x = np.mgrid[0:cfg.height, 0:cfg.width].astype(np.float64)
    rng = np.random.default_rng(seed)
    planes = [128 + 70 * np.sin(x / (7 + 3 * c)) * np.cos(y / (9 - 2 * c))
              + 20 * rng.standard_normal(x.shape) for c in range(3)]
    return np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module", params=(8, 24), ids=("d8", "d24"))
def blobs(request):
    cfg = _config(request.param)
    return [J.compress_ycbcr(_image(cfg, 30 + i), cfg, device="cpu")
            for i in range(MANY)]


@pytest.fixture(scope="module", params=(8, 24), ids=("d8", "d24"))
def tiny(request):
    """8x8 images: one block of stream a band."""
    cfg = _config(request.param, width=8, height=8)
    return [J.compress_ycbcr(_image(cfg, 40 + i), cfg, device="cpu")
            for i in range(MANY)]


def _total(blob):
    _, data = J.container.read_data(blob)
    return len(data.y) + len(data.cb) + len(data.cr)


CUDA = torch.device("cuda")


def _as_on_cuda(monkeypatch):
    """``decode_scan`` decides as for a CUDA device, whatever device the
    decode runs on: the rule's CUDA branch on the CPU path."""
    rule = DS.decode_scan
    monkeypatch.setattr(DS, "decode_scan",
                        lambda n_bytes, scan, dev: rule(n_bytes, scan, CUDA))


def _without_native(monkeypatch):
    monkeypatch.setattr(entropy, "_native", None)
    monkeypatch.setattr(entropy, "_native_checked", True)


def _decode(entry, blobs, scan):
    """Every blob through ``entry`` as uint8 arrays."""
    if entry == "decompress_many":
        return J.decompress_many(blobs, device="cpu", scan=scan)
    if entry == "decompress_to_ycbcr":
        return [J.decompress_to_ycbcr(b, device="cpu", scan=scan)
                for b in blobs]
    return [np.asarray(J.Jpeg.decompress(b, device="cpu", scan=scan))
            for b in blobs]


def _recorded(fn):
    P.start_recording()
    try:
        out = fn()
    finally:
        P.stop_recording()
    return out, P.recorded()


# ---------------------------------------------------------------------------
# The rule's choices
# ---------------------------------------------------------------------------

PY_MIN = DS.PY_SCAN_DEVICE_MIN_BYTES
SIZES = (0, 1, 9, PY_MIN - 1, PY_MIN, 1 << 16, 1 << 30)


@pytest.mark.parametrize("n_bytes,scan,device,native,want", [
    (9, "auto", "cuda", True, "device"),
    (1, "auto", "cuda", True, "device"),
    (1 << 30, "auto", "cuda", True, "device"),
    (0, "auto", "cuda", True, "device"),
    (9, "auto", "cuda:0", True, "device"),
    (1 << 30, "auto", "cpu", True, "host"),
    (1 << 30, "host", "cuda", True, "host"),
    (8, "device", "cuda", True, "device"),
    (1 << 30, "host", "cpu", True, "host"),
    (10, "device", "cpu", True, "device"),
    (PY_MIN, "auto", "cuda", False, "device"),
    (PY_MIN - 1, "auto", "cuda", False, "device"),
    (1 << 30, "auto", "cpu", False, "host"),
    (1 << 30, "host", "cuda", False, "host"),
], ids=lambda v: str(v))
def test_decode_rule_choices(monkeypatch, n_bytes, scan, device, native,
                             want):
    if not native:
        _without_native(monkeypatch)
    else:
        assert entropy._get_native() is not None
    assert DS.decode_scan(n_bytes, scan, torch.device(device)) == want


def test_decode_rule_is_the_same_without_native(monkeypatch):
    """A decode's rule does not read whether the C++ scanner exists, size
    for size and on either device; a scan it does not know raises."""
    want = {(n, d, s): DS.decode_scan(n, s, torch.device(d))
            for n in SIZES for d in ("cuda", "cpu")
            for s in ("auto", "host", "device")}
    _without_native(monkeypatch)
    for (n, d, s), mode in want.items():
        assert DS.decode_scan(n, s, torch.device(d)) == mode, (n, d, s)
    with pytest.raises(ValueError, match="scan must be one of"):
        DS.decode_scan(1 << 20, "gpu", CUDA)


# ---------------------------------------------------------------------------
# entropy.scan_offsets keeps its own rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_bytes", [9, PY_MIN, 1 << 16, 1 << 30])
def test_standalone_auto_stays_on_the_host(n_bytes):
    assert entropy._get_native() is not None
    assert DS.scan_mode(n_bytes, "auto", "cuda") == "host"
    assert DS.scan_mode(n_bytes, "auto", CUDA) == "host"


def test_scan_offsets_auto_runs_the_host_scanner(blobs):
    """``entropy.scan_offsets(device="cuda")`` on a stream of more than
    ``PY_SCAN_DEVICE_MIN_BYTES`` scans on the host: no CUDA device is
    touched (there is none here), the starts are the C++ scanner's and the
    span is ``scan.host``."""
    cfg, data = J.container.read_data(blobs[0])
    L = cfg.dct_size ** 2
    stream = b"".join([data.y] * (PY_MIN // max(1, len(data.y)) + 1))
    nb = cfg.num_blocks * (len(stream) // len(data.y))
    assert len(stream) >= PY_MIN
    got, rec = _recorded(lambda: entropy.scan_offsets(stream, nb, L,
                                                      device="cuda"))
    np.testing.assert_array_equal(got, NC.scan_offsets(stream, nb, L))
    assert [s.name for s in rec.spans] == ["scan.host"]
    assert rec.counts == {}


# ---------------------------------------------------------------------------
# The device scan in a decode's place: same answers, same errors
# ---------------------------------------------------------------------------

def _auto_equals_host(blobs, entry, monkeypatch):
    want = _decode(entry, blobs, "host")
    _as_on_cuda(monkeypatch)
    got, rec = _recorded(lambda: _decode(entry, blobs, "auto"))
    names = [s.name for s in rec.spans]
    assert names.count("scan.device") == MANY and "scan.host" not in names
    assert rec.counts.get("scan.auto_device") == MANY
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == np.uint8
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("entry", ENTRIES)
def test_auto_on_cuda_equals_the_host_scan(blobs, entry, monkeypatch):
    _auto_equals_host(blobs, entry, monkeypatch)


@pytest.mark.parametrize("entry", ENTRIES)
def test_auto_on_cuda_takes_the_device_scan_at_one_block(tiny, entry,
                                                         monkeypatch):
    """Down to one block of stream a band, the device scan's answer is the
    host scan's: ``auto`` needs no size below which it keeps the host."""
    assert {J.container.read_data(b)[0].num_blocks for b in tiny} == {1}
    _auto_equals_host(tiny, entry, monkeypatch)


def _truncated(blob):
    return blob[:-3]


def _corrupted(blob):
    """The first of a fixed list of byte changes, in every band, that the
    host scanner rejects."""
    cfg, data = J.container.read_data(blob)
    L = cfg.dct_size ** 2
    head = len(blob) - _total(blob)
    for off in range(0, len(data.y), 3):
        for mask in (0xFF, 0x0F, 0xF0):
            bad = bytearray(blob)
            bad[head + off] ^= mask
            try:
                _, d = J.container.read_data(bytes(bad))
                for s in (d.y, d.cb, d.cr):
                    NC.scan_offsets(s, cfg.num_blocks, L)
            except Exception:
                return bytes(bad)
    raise AssertionError("no change of the list is rejected")


def _error(fn):
    try:
        fn()
    except Exception as e:          # the host scan's error, whatever it is
        return type(e), str(e)
    raise AssertionError("no error")


@pytest.mark.parametrize("spoil", [_truncated, _corrupted],
                         ids=("truncated", "corrupted"))
@pytest.mark.parametrize("entry", ENTRIES)
def test_bad_containers_raise_the_host_scans_error(blobs, entry, spoil,
                                                   monkeypatch):
    bad = [blobs[0], spoil(blobs[1])]
    want = _error(lambda: _decode(entry, bad, "host"))
    assert want[0] is not RuntimeError
    _as_on_cuda(monkeypatch)
    assert DS.decode_scan(_total(blobs[0]), "auto",
                            torch.device("cpu")) == "device"
    assert _error(lambda: _decode(entry, bad, "auto")) == want
    assert _error(lambda: _decode(entry, bad, "device")) == want


# ---------------------------------------------------------------------------
# The counter scan.auto_device
# ---------------------------------------------------------------------------

def _counted(fn):
    _, rec = _recorded(fn)
    return rec.counts.get("scan.auto_device", 0)


@pytest.mark.parametrize("entry", ENTRIES + ("decompress_to_device",))
def test_auto_device_counts_each_auto_decode(blobs, entry, monkeypatch):
    _as_on_cuda(monkeypatch)
    if entry == "decompress_to_device":
        def call(scan):
            return [J.decompress_to_device(b, device="cpu", scan=scan)
                    for b in blobs]
    else:
        def call(scan):
            return _decode(entry, blobs, scan)
    assert _counted(lambda: call("auto")) == MANY
    assert _counted(lambda: call("device")) == 0
    assert _counted(lambda: call("host")) == 0


@pytest.mark.parametrize("entry", ENTRIES)
def test_auto_device_never_counts_on_the_cpu(blobs, entry):
    assert _counted(lambda: _decode(entry, blobs, "auto")) == 0
    assert _counted(lambda: _decode(entry, blobs, "device")) == 0


def test_auto_device_counts_without_native(tiny, monkeypatch):
    """Without the C++ scanner an ``"auto"`` decode takes the device scan
    and counts too, below ``PY_SCAN_DEVICE_MIN_BYTES`` as well."""
    assert max(map(_total, tiny)) < PY_MIN
    _as_on_cuda(monkeypatch)
    _without_native(monkeypatch)
    assert _counted(lambda: _decode("decompress_to_ycbcr", tiny,
                                    "auto")) == MANY
