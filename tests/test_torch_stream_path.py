"""The decode's stream path: a container's band bytes reach the device in
one copy, from the caller's memory, with no host copy before it.

* Full chroma (bs 1, d 8, the JPEG luminance table), the benchmark's
  ``photo24mp_444`` configuration at 44 x 60 (padded) and 48 x 64 (not
  padded): every entry under both scans gives planes within the tie
  contract of ``port_bench/reference/codec.py``'s float64 decode of the
  reference's own container.
* The buffer handed to ``upload_stream``, the one function that moves the
  stream, is the caller's container memory, and on the CPU the moved
  stream is that memory too.
* Truncated, inconsistent and rejected containers raise what the decode
  raised when it copied the bands first: ``read_data``'s errors, then the
  host scanner's error of the first band it rejects, under both scans.
* ``decode.stream_bytes`` counts the bands' bytes.  A device-scan decode
  whose bands have more than ``CHASE_DIRECT_MAX`` blocks takes the
  segmented scan (``scan.segmented``), so K8's long form, which
  ``scan.chase_long`` counted, no longer runs in a decode.
"""
import os
import struct
import sys

import numpy as np
import pytest
import torch

import jpeg_tpu_torch as J
from jpeg_tpu_torch import api, container
from jpeg_tpu_torch.entropy import device_scan as DS
from jpeg_tpu_torch.ops import kernels as K
from jpeg_tpu_torch.utils import profiling as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from port_bench.frames import synth_frames  # noqa: E402
from port_bench.reference import codec as R  # noqa: E402

ENTRIES = ("decompress_to_device", "decompress_to_ycbcr", "decompress_many")
SCANS = ("host", "device")
PHOTO = {"block_size": 1, "dct_size": 8, "transform": "DCT",
         "quantization": {"name": "qtable", "params": {}}}


def _codec(h, w):
    return R.Codec.from_settings(PHOTO, h, w)


def _blob(h, w, seed):
    """The reference's container of a seeded frame, and its codec."""
    codec = _codec(h, w)
    frame = synth_frames(1, h, w, seed, "cpu")[0]
    return R.encode_container(codec, frame), codec


@pytest.fixture(scope="module")
def small():
    return _blob(44, 60, 2 ** 31 + 24)


def _band_spans(blob):
    """Each band's (offset, length) in a whole container, read here from
    its u16 header length and u32 band lengths."""
    (pos,) = struct.unpack_from("<H", blob, 0)
    spans = []
    for _ in range(3):
        (n,) = struct.unpack_from("<L", blob, pos)
        spans.append((pos + 4, n))
        pos += 4 + n
    return spans


def _planes(entry, blob, scan):
    """One call of ``entry``: its answer as (3, H, W) planes."""
    if entry == "decompress_many":
        out, = J.decompress_many([blob], device="cpu", scan=scan)
    else:
        out = getattr(J, entry)(blob, device="cpu", scan=scan)
    if isinstance(out, torch.Tensor):
        return out
    return torch.from_numpy(np.ascontiguousarray(out)).permute(2, 0, 1)


@pytest.mark.parametrize("scan", SCANS)
@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("hw", [(44, 60), (48, 64)])
def test_full_chroma_within_the_tie_contract(hw, entry, scan):
    blob, codec = _blob(*hw, seed=sum(hw))
    want, ties = R.decode_planes(codec, R.decode_container_levels(codec,
                                                                  blob))
    got = _planes(entry, blob, scan)
    assert got.shape == want.shape == (3, *hw)
    diff = got.to(torch.int64) - want.to(torch.int64)
    assert int(((diff != 0) & (~ties | (diff.abs() > 1))).sum()) == 0


def _spy_uploads(monkeypatch):
    """Every buffer handed to ``upload_stream`` and the tensor it gave."""
    seen = []
    real = api.DC.upload_stream

    def spy(data, dev):
        out = real(data, dev)
        seen.append((data, out))
        return out
    monkeypatch.setattr(api.DC, "upload_stream", spy)
    return seen


@pytest.mark.parametrize("scan", SCANS)
@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("kind", [bytes, bytearray])
def test_stream_moved_from_the_callers_memory(small, monkeypatch, kind,
                                              entry, scan):
    blob = kind(small[0])
    mine = np.frombuffer(blob, dtype=np.uint8)
    seen = _spy_uploads(monkeypatch)
    _planes(entry, blob, scan)
    (data, moved), = seen
    spans = _band_spans(blob)
    first, (last, n) = spans[0][0], spans[-1]
    handed = np.frombuffer(data, dtype=np.uint8)
    assert np.shares_memory(handed, mine)
    # The bands and the two length fields between them, in place.
    assert handed.ctypes.data == mine.ctypes.data + first
    assert handed.size == last + n - first
    # On the CPU the "device copy" is no copy: the stream is the caller's.
    assert np.shares_memory(moved.numpy(), mine)


def test_read_band_spans_locate_read_datas_bands(small):
    blob = small[0]
    for cut in (0, 1, 3, 40):
        b = blob[:len(blob) - cut]
        cfg, data = container.read_data(b)
        cfg2, spans = container.read_band_spans(b)
        assert cfg2 == cfg
        assert [bytes(b[p:p + n]) for p, n in spans] == [data.y, data.cb,
                                                         data.cr]
        assert all(type(x) is bytes for x in (data.y, data.cb, data.cr))


def _with_u32(blob, pos, delta):
    b = bytearray(blob)
    (v,) = struct.unpack_from("<L", b, pos)
    struct.pack_into("<L", b, pos, v + delta)
    return bytes(b)


FAULTS = ("header_cut", "length_cut", "y_cut", "cr_cut", "cr_one_byte",
          "y_length_plus_1", "cb_length_minus_1", "cr_length_past_the_end",
          "trailing_byte", "bad_code", "bands_shorter_than_their_blocks",
          "cr_byte_flipped")


def _faults(blob):
    """Containers that are cut, inconsistent or rejected, by name."""
    spans = _band_spans(blob)
    (y, ny), (cb, ncb), (cr, ncr) = spans
    bad_code = bytearray(blob)
    bad_code[cb] = 0x70                 # run 7 with size 0: no code
    tall = bytearray(blob)
    struct.pack_into("<H", tall, 4, 4000)   # far more blocks than bytes
    mid = bytearray(blob)
    mid[cr + ncr // 2] ^= 0xFF
    return {
        "header_cut": blob[:12],
        "length_cut": blob[:y - 2],
        "y_cut": blob[:y + ny // 2],
        "cr_cut": blob[:-3],
        "cr_one_byte": blob[:cr + 1],
        "y_length_plus_1": _with_u32(blob, y - 4, 1),
        "cb_length_minus_1": _with_u32(blob, cb - 4, -1),
        "cr_length_past_the_end": _with_u32(blob, cr - 4, 5),
        "trailing_byte": blob + b"\x00",
        "bad_code": bytes(bad_code),
        "bands_shorter_than_their_blocks": bytes(tall),
        "cr_byte_flipped": bytes(mid),
    }


def _copying_decode_error(blob):
    """What the decode raised when it copied the bands first, under either
    scan: ``read_data``'s error, else the host scanner's on the first band
    it rejects; None where the container decodes."""
    try:
        cfg, data = container.read_data(blob)
        for band in (data.y, data.cb, data.cr):
            DS._host_scan(band, cfg.num_blocks, cfg.dct_size ** 2)
    except Exception as e:                  # noqa: BLE001 - compared below
        return type(e), str(e)
    return None


@pytest.mark.parametrize("scan", SCANS)
@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("fault", FAULTS)
def test_faulty_containers_raise_as_the_copying_decode(small, fault, entry,
                                                       scan):
    blob = _faults(small[0])[fault]
    want = _copying_decode_error(blob)
    if want is None:
        # The copying decode took it (trailing bytes, a last length past
        # the end): so does this one, with the container's own planes.
        assert fault in ("trailing_byte", "cr_length_past_the_end")
        assert torch.equal(_planes(entry, blob, scan),
                           _planes(entry, small[0], scan))
        return
    with pytest.raises(want[0]) as got:
        _planes(entry, blob, scan)
    assert str(got.value) == want[1]


def _recorded(entry, blob, scan):
    P.start_recording()
    try:
        _planes(entry, blob, scan)
    finally:
        P.stop_recording()
    return P.recorded().counts


@pytest.mark.parametrize("scan", SCANS)
@pytest.mark.parametrize("entry", ENTRIES)
def test_stream_bytes_counts_the_bands(small, entry, scan):
    blob = small[0]
    counts = _recorded(entry, blob, scan)
    spans = _band_spans(blob)
    assert counts["decode.stream_bytes"] == sum(n for _, n in spans)
    assert "scan.chase_long" not in counts      # 48 blocks a band


@pytest.mark.parametrize("scan", SCANS)
@pytest.mark.parametrize("hw,nb", [((256, 256), 1024), ((264, 256), 1056)])
def test_chase_long_counts_bands_past_the_direct_form(hw, nb, scan):
    """A band of ``CHASE_DIRECT_MAX`` blocks takes K8's short form; one
    more is past it, where the segmented scan takes the band, so K8's long
    form does not run and ``scan.chase_long`` is never counted; only the
    device scan runs either."""
    blob, codec = _blob(*hw, seed=nb)
    assert codec.num_blocks == nb and K.CHASE_DIRECT_MAX == 1024
    assert DS.SEGMENTED_MIN_BLOCKS == K.CHASE_DIRECT_MAX + 1
    counts = _recorded("decompress_to_device", blob, scan)
    segmented = scan == "device" and nb > K.CHASE_DIRECT_MAX
    assert "scan.chase_long" not in counts
    assert counts.get("scan.segmented", 0) == int(segmented)
    spans = _band_spans(blob)
    assert counts["decode.stream_bytes"] == sum(n for _, n in spans)
