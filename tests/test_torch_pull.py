"""The host→host decode's plane pull (``jpeg_tpu_torch/api.py:_pull``).

* Answers of ``decompress_to_ycbcr``, ``decompress_many`` and
  ``Jpeg.decompress`` equal the pageable ``.cpu()`` pull of the same
  planes, with its shape, dtype and strides: under both scans, at d 8 and
  d 24, on the CPU path and with CPU tensors standing in for the pinned
  blocks (``_pinned_empty`` patched, so the pinned path runs here).
* The bound: under ``_PINNED_ANSWER_BYTES`` an answer is a view of a
  block, counted by its power-of-two size; past it the pull is pageable
  and counts ``decode.pull_pageable``; a block's bytes come back only when
  the last view and sub-view of its answer have died; the count stays
  exact with many threads pulling and dropping answers at once.
"""
import gc
import random
import sys
import threading

import numpy as np
import pytest
import torch

import jpeg_tpu_torch as J
from jpeg_tpu_torch import api
from jpeg_tpu_torch.utils import profiling as P

torch.set_num_threads(2)

SCANS = ("host", "device")
MANY = 3


def _config(d):
    if d == 8:
        return J.Configuration(width=40, height=24, block_size=2,
                               dct_size=8, transform="DCT",
                               quantization=J.QuantizationMethod("qtable"))
    return J.Configuration(width=50, height=30, block_size=2, dct_size=24,
                           transform="DCT",
                           quantization=J.QuantizationMethod(
                               "divide", divisor=1000))


@pytest.fixture(scope="module", params=(8, 24), ids=("d8", "d24"))
def blob(request):
    cfg = _config(request.param)
    rng = np.random.default_rng(19)
    img = rng.integers(0, 256, (cfg.height, cfg.width, 3), dtype=np.uint8)
    return J.compress_ycbcr(img, cfg, device="cpu")


class _Blocks:
    """CPU tensors in place of pinned blocks: ``_pinned_empty`` patched to
    hand out plain ``torch.empty`` blocks, each one kept by its data
    pointer."""

    def __init__(self, monkeypatch):
        self.made = {}                 # data pointer -> block, kept alive
        self.lock = threading.Lock()
        monkeypatch.setattr(api, "_pinned_empty", self.empty)

    def empty(self, planes):
        block = torch.empty(planes.shape, dtype=torch.uint8)
        with self.lock:
            self.made[block.data_ptr()] = block
        return block

    def backs(self, answer):
        """Whether ``answer`` is a view of one of these blocks, through
        the ndarray over it (``.base``) and the tensor under that."""
        base = answer.base.base if answer.base is not None else None
        return isinstance(base, torch.Tensor) and \
            base.data_ptr() in self.made


@pytest.fixture
def blocks(monkeypatch):
    return _Blocks(monkeypatch)


@pytest.fixture(autouse=True)
def _nothing_held():
    """Every test starts and ends with no pinned bytes counted and
    recording off."""
    gc.collect()
    assert api._PINNED.held == 0
    assert not P._RECORDER.on
    yield
    while P._RECORDER.depth:
        P.stop_recording()
    gc.collect()
    assert api._PINNED.held == 0


def _width(blob):
    return J.container.read_data(blob)[0].width


def _block_bytes(answer):
    return 1 << (answer.nbytes - 1).bit_length()


def _pageable(blob, scan):
    """Today's pull: the planes' ``.cpu().numpy().transpose(1, 2, 0)``."""
    planes = J.decompress_to_device(blob, device="cpu", scan=scan)
    return planes.cpu().numpy().transpose(1, 2, 0)


def _answers(entry, blob, scan):
    if entry == "decompress_many":
        return J.decompress_many([blob] * MANY, device="cpu", scan=scan)
    if entry == "Jpeg.decompress":
        return [J.Jpeg.decompress(blob, device="cpu", scan=scan)]
    return [J.decompress_to_ycbcr(blob, device="cpu", scan=scan)]


def _same(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.strides == want.strides
    assert np.array_equal(got, want)


@pytest.mark.parametrize("pinned", (False, True), ids=("cpu", "pinned"))
@pytest.mark.parametrize("scan", SCANS)
@pytest.mark.parametrize("entry", ("decompress_to_ycbcr", "decompress_many",
                                   "Jpeg.decompress"))
def test_answers_equal_the_pageable_pull(blob, entry, scan, pinned,
                                         monkeypatch):
    want = _pageable(blob, scan)
    made = _Blocks(monkeypatch) if pinned else None
    answers = _answers(entry, blob, scan)
    assert len(answers) == (MANY if entry == "decompress_many" else 1)
    for got in answers:
        if entry == "Jpeg.decompress":
            # A PIL image made from the answer (it copies the pixels).
            assert got.mode == "YCbCr"
            assert np.array_equal(np.asarray(got), want)
            continue
        _same(got, want)
        if made is not None:
            assert made.backs(got)
            assert got.base.base.shape == (3,) + want.shape[:2]
    if pinned and entry != "Jpeg.decompress":
        assert api._PINNED.held == sum(map(_block_bytes, answers))
    del answers
    gc.collect()


def test_cpu_planes_take_no_block_and_count_nothing(blob):
    P.start_recording()
    try:
        answer = J.decompress_to_ycbcr(blob, device="cpu")
    finally:
        P.stop_recording()
    assert api._pinned_empty(torch.zeros(3, 2, 2, dtype=torch.uint8)) \
        is None
    assert api._PINNED.held == 0
    assert "decode.pull_pageable" not in P.recorded().counts
    _same(answer, _pageable(blob, "auto"))


def test_block_bytes_are_the_allocators_power_of_two():
    planes = torch.zeros(3, 2160, 3840, dtype=torch.uint8)
    with pytest.MonkeyPatch.context() as m:
        _Blocks(m)
        answer = api._pull(planes)
        assert api._PINNED.held == 32 << 20       # 24.9 MB -> 32 MiB
        del answer
    assert api._PINNED.held == 0


def test_past_the_bound_the_pull_is_pageable_and_counted(blob, blocks,
                                                         monkeypatch):
    want = _pageable(blob, "host")
    one = _block_bytes(want)
    monkeypatch.setattr(api, "_PINNED_ANSWER_BYTES", 2 * one)
    P.start_recording()
    try:
        kept = [J.decompress_to_ycbcr(blob, device="cpu") for _ in range(4)]
    finally:
        P.stop_recording()
    assert [blocks.backs(a) for a in kept] == [True, True, False, False]
    assert P.recorded().counts.get("decode.pull_pageable") == 2
    for a in kept:
        _same(a, want)
    assert api._PINNED.held == 2 * one
    # One answer dies: the next pull is pinned again, within the bound.
    del kept[0]
    assert api._PINNED.held == one
    kept.append(J.decompress_to_ycbcr(blob, device="cpu"))
    assert blocks.backs(kept[-1]) and api._PINNED.held == 2 * one


def test_bytes_come_back_when_the_last_view_dies(blob, blocks):
    answer = J.decompress_to_ycbcr(blob, device="cpu")
    one = _block_bytes(answer)
    assert api._PINNED.held == one
    row = answer[1]                            # a view: (W, 3)
    column = row[:, 2]                         # a view of the view: (W,)
    flat = answer.base.reshape(-1)             # a view of the base
    del answer
    gc.collect()
    assert api._PINNED.held == one
    del row, flat
    gc.collect()
    assert api._PINNED.held == one
    keep = column.copy()
    del column
    assert api._PINNED.held == 0
    assert keep.shape == (_width(blob),)


def test_a_failed_copy_gives_its_bytes_back(blocks, monkeypatch):
    def broken(planes):
        block = torch.empty(planes.shape, dtype=torch.uint8)
        return block[..., :0]              # wrong shape: copy_ raises

    monkeypatch.setattr(api, "_pinned_empty", broken)
    planes = torch.zeros(3, 4, 4, dtype=torch.uint8)
    with pytest.raises(RuntimeError):
        api._pull(planes)
    gc.collect()
    assert api._PINNED.held == 0


def test_the_count_stays_exact_under_many_threads(blocks, monkeypatch):
    """Threads pull and drop answers at once, under a bound of a few
    blocks: the count never passes the bound, every answer is right, and
    it comes back to the bytes of the answers still held, then to 0."""
    planes = torch.arange(3 * 16 * 16, dtype=torch.int64).remainder(251) \
        .to(torch.uint8).reshape(3, 16, 16)
    want = planes.numpy().transpose(1, 2, 0)
    one = _block_bytes(want)
    monkeypatch.setattr(api, "_PINNED_ANSWER_BYTES", 5 * one)
    seen_over, errors, kept = [], [], []
    take = api._PINNED.take

    def watched_take(nbytes):
        ok = take(nbytes)
        if api._PINNED.held > api._PINNED_ANSWER_BYTES:
            seen_over.append(api._PINNED.held)
        return ok

    monkeypatch.setattr(api._PINNED, "take", watched_take)
    threads, per = 12, 200

    def work(seed):
        rng = random.Random(seed)
        mine = []
        try:
            for _ in range(per):
                a = api._pull(planes)
                if not np.array_equal(a, want):
                    errors.append("wrong answer")
                mine.append(a)
                while len(mine) > rng.randrange(4):
                    mine.pop(rng.randrange(len(mine)))
            kept.extend(mine)
        except Exception as e:             # reported below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work, args=(i,))
                for i in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in pool)
    assert errors == [] and seen_over == []
    pinned = sum(blocks.backs(a) for a in kept)
    assert api._PINNED.held == pinned * one <= 5 * one
    del kept[:]
    gc.collect()
    assert api._PINNED.held == 0
