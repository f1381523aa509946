"""A configuration is added to the benchmark as files only.

* A full-chroma (bs 1, d 8, qtable) configuration file with its own tiny
  frame, a ``decode_to_device`` cell on it and that cell's name appended to
  the lists of the metrics the to-device cells report, runs in a tiny copy
  made by ``make_tiny_root``: traced, every program reader of the to-device
  cells reads a finite value of 0 or more; untraced, it reports its
  end-to-end metrics; both ``correct``, with no bad pixel.
* A configuration file without its tiny frame is refused by name.
* Every configuration's tiny frame is padded, at the block size and at the
  transform size, wherever its full frame is, so the tiny copy takes the
  same crops.
"""
import json
import math
import os
import shutil

import pytest

from conftest import ROOT, make_tiny_root
from port_bench import harness

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    MANIFEST = json.load(_f)

#: Full chroma (bs 1, no subsampling), d 8 and the JPEG luminance table on
#: 6000 x 4000 frames, with the frame of its tiny copy in its own file.
PHOTO = {"name": "photo_444", "source": "test",
         "codec": {"block_size": 1, "dct_size": 8, "transform": "DCT",
                   "quantization": {"name": "qtable", "params": {}},
                   "dtype": "float32"},
         "frame": {"height": 4000, "width": 6000, "channels": 3,
                   "colorspace": "YCbCr", "dtype": "uint8"},
         "tiny_frame": {"height": 44, "width": 60},
         "reduced": []}
PHOTO_CELL = "photo_444.decode_to_device"
E2E = "decode_to_device_mps"

#: The to-device cells' readers of the program's spans and counters: off
#: the card they read, where the device readers find no device events.
READERS = sorted(x["name"] for x in MANIFEST["per_layer"]
                 if x["moves"] == E2E
                 and x["source"] in ("program_span", "program_counter"))


def _checkout_with(tmp, config):
    """A copy of the benchmark's manifest and data files with ``config``
    added as a file of its own and a ``decode_to_device`` cell on it, named
    in the lists of every metric that the to-device cells report."""
    src = os.path.join(str(tmp), "src")
    for d in ("configs", "metrics", "traffic"):
        shutil.copytree(os.path.join(ROOT, "port_bench", d),
                        os.path.join(src, "port_bench", d))
    m = json.loads(json.dumps(MANIFEST))
    file = f"port_bench/configs/{config['name']}.json"
    with open(os.path.join(src, file), "w") as f:
        json.dump(config, f)
    m["configs"].append({"name": config["name"], "source": "test",
                         "file": file, "reduced": [], "why": "test"})
    m["workloads"].append({"name": PHOTO_CELL, "config": config["name"],
                           "traffic": "decode_to_device", "chips": 1,
                           "why": "test"})
    for x in m["end_to_end"] + m["per_layer"]:
        if "workloads" in x and E2E in (x["name"], x.get("moves")):
            x["workloads"].append(PHOTO_CELL)
    with open(os.path.join(src, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    return src


@pytest.fixture(scope="module")
def photo_runs(tmp_path_factory):
    """A traced and an untraced CPU run of the added cell's tiny copy."""
    tmp = tmp_path_factory.mktemp("photo_checkout")
    root = str(tmp / "tiny")
    make_tiny_root(root, source=_checkout_with(tmp, PHOTO))
    return {traced: harness.execute(root, PHOTO_CELL, 2 ** 31 + 2301, 0.3,
                                    traced, "cpu")
            for traced in (True, False)}


def _sound(r):
    assert r["correct"] is True and r["failed"] == 0, r["checks"]
    assert r["checks"]["bad_pixels"]["value"] == 0
    assert r["checks"]["missing"]["value"] == 0


def test_to_device_readers_found():
    assert len(READERS) >= 7


@pytest.mark.parametrize("reader", READERS)
def test_added_configuration_reports_every_reader_traced(photo_runs, reader):
    r = photo_runs[True]
    _sound(r)
    got = r["metrics"][reader]
    assert math.isfinite(got["value"]) and got["value"] >= 0


def test_added_configuration_reports_its_end_to_end_metrics(photo_runs):
    r = photo_runs[False]
    _sound(r)
    assert set(r["metrics"]) == {E2E, "setup_s"}
    assert r["metrics"][E2E]["value"] > 0


def test_tiny_copy_refuses_a_configuration_without_its_tiny_frame(tmp_path):
    config = {k: v for k, v in PHOTO.items() if k != "tiny_frame"}
    src = _checkout_with(tmp_path, config)
    with pytest.raises(ValueError, match=r"photo_444\.json.*'tiny_frame'"):
        make_tiny_root(str(tmp_path / "tiny"), source=src)


def _padded(n, bs, d):
    """Whether a side of ``n`` pixels is edge-padded to a multiple of the
    block size, and its ceil(n / bs) blocks to a multiple of d."""
    return n % bs != 0, -(-n // bs) % d != 0


@pytest.mark.parametrize("file", [c["file"] for c in MANIFEST["configs"]])
def test_tiny_frame_is_padded_wherever_the_full_frame_is(file):
    """The tiny copy takes every padding, and so every crop, that the
    configuration's full frame takes."""
    with open(os.path.join(ROOT, file)) as f:
        cfg = json.load(f)
    bs, d = cfg["codec"]["block_size"], cfg["codec"]["dct_size"]
    for side in ("height", "width"):
        full, tiny = cfg["frame"][side], cfg["tiny_frame"][side]
        assert 1 <= tiny <= full
        for f_pad, t_pad in zip(_padded(full, bs, d), _padded(tiny, bs, d)):
            assert t_pad or not f_pad, (side, full, tiny)
