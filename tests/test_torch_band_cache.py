"""The band modules' buffer cache (``jpeg_tpu_torch/ops/band.py``).

* A second module of one key finds the first one's buffers: the same
  tensor objects, one ``band.cache_hits`` and no ``band.builds``.
* Over every encode and decode branch (DCT / DFT, d 8 / 24, bs 1 / 4) a
  module whose buffers came from the cache gives the answers of one built
  with the cache cleared, bit for bit.
* Keys that differ in dtype, device, block size, transform, d or the
  quantizer's parameters never share an entry; frames of two sizes at one
  setting share theirs, and the kernel branch shares the chain branch's
  d*d decode operator at every block size.
* A share built with ``_image=`` beside a whole image of the share's own
  geometry keeps the whole image's branch, in either order.
* The byte bound evicts the least recently used entry of the device and
  keeps the newest; nothing writes a cached tensor in place; threads that
  miss together make one entry; ``.to`` still moves a module.
"""
import os
import sys
import threading

import numpy as np
import pytest
import torch

import jpeg_tpu_torch as J
from jpeg_tpu_torch.config import Configuration, QuantizationMethod
from jpeg_tpu_torch.ops import band
from jpeg_tpu_torch.ops import transform as T
from jpeg_tpu_torch.ops.band import BandDecoder, BandEncoder
from jpeg_tpu_torch.parallel import sharded
from jpeg_tpu_torch.utils import profiling as P

torch.set_num_threads(2)

F32, F64 = torch.float32, torch.float64
FRACTIONAL = ("divide", {"divisor": 2.5})  # no integer dequantizer


@pytest.fixture(autouse=True)
def _cleared():
    """Every test starts with an empty cache and recording off."""
    band._CACHE.clear()
    assert not P._RECORDER.on
    yield
    while P._RECORDER.depth:
        P.stop_recording()


def _cfg(h, w, bs=2, d=8, transform="DCT", quant=("qtable", {})):
    return Configuration(width=w, height=h, block_size=bs, dct_size=d,
                         transform=transform,
                         quantization=QuantizationMethod(quant[0],
                                                         **quant[1]))


def _geometry(d, bs, divisible):
    """(h, w): divisible by d * bs on both axes, or padded on both."""
    D = d * bs
    return (D, 2 * D) if divisible else (D + bs * 3, 2 * D - bs * 5)


def _buffers(m):
    return dict(m.named_buffers())


def _recorded(fn):
    P.start_recording()
    try:
        out = fn()
    finally:
        P.stop_recording()
    return out, P.recorded().counts


# (module, branch, transform, quantizer, divisible geometry, dtype)
BRANCHES = [
    (BandEncoder, "separable", "DCT", ("none", {}), True, F32),
    (BandEncoder, "sep_pad", "DCT", ("divide", {"divisor": 1000}), False,
     F32),
    (BandEncoder, "combined", "DFT", ("divide", {"divisor": 40}), True, F32),
    (BandEncoder, "blocks", "DFT", ("none", {}), False, F32),
    (BandEncoder, "parity", "DCT", ("discard", {"keep": 3}), False, F64),
    (BandDecoder, "kernel", "DCT", ("divide", {"divisor": 1000}), False,
     F32),
    (BandDecoder, "combined", "DFT", FRACTIONAL, True, F32),
    (BandDecoder, "chain", "DCT", FRACTIONAL, False, F32),
    (BandDecoder, "parity", "DFT", ("divide", {"divisor": 40}), False, F64),
]
BRANCH_IDS = [f"{m.__name__[4:].lower()}-{b}" for m, b, *_ in BRANCHES]


def _module_and_input(case, d, bs, seed=0):
    """The case's module class, its arguments and a seeded input."""
    cls, branch, transform, quant, divisible, dtype = case
    h, w = _geometry(d, bs, divisible)
    cfg = _cfg(h, w, bs, d, transform, quant)
    rng = np.random.default_rng(seed)
    if cls is BandEncoder:
        x = torch.from_numpy(rng.integers(0, 256, (2, h, w), np.uint8))
    else:
        x = torch.from_numpy(rng.integers(
            -12, 13, (2, cfg.num_blocks, d * d)).astype(np.int32))
    return cls, cfg, dtype, x


@pytest.mark.parametrize("case", BRANCHES, ids=BRANCH_IDS)
def test_second_module_finds_the_first_ones_buffers(case):
    cls, cfg, dtype, _ = _module_and_input(case, 8, 2)
    first, counts = _recorded(lambda: cls(cfg, dtype))
    assert first.branch == case[1]
    # The f64 decoder holds no buffer: it has nothing to build.
    assert counts == ({"band.builds": 1} if _buffers(first)
                      else {"band.cache_hits": 1})
    second, counts = _recorded(lambda: cls(cfg, dtype))
    assert counts == {"band.cache_hits": 1}
    a, b = _buffers(first), _buffers(second)
    assert list(a) == list(b)
    assert all(a[k] is b[k] for k in a)


@pytest.mark.parametrize("bs", [1, 4])
@pytest.mark.parametrize("d", [8, 24])
@pytest.mark.parametrize("case", BRANCHES, ids=BRANCH_IDS)
def test_cached_module_answers_as_a_fresh_one(case, d, bs):
    cls, cfg, dtype, x = _module_and_input(case, d, bs, seed=d + bs)
    cls(cfg, dtype)
    cached = cls(cfg, dtype)
    band._CACHE.clear()
    fresh = cls(cfg, dtype)
    assert cached.branch == fresh.branch == case[1]
    a, b = _buffers(cached), _buffers(fresh)
    assert list(a) == list(b)
    for k in a:
        assert a[k] is not b[k]
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    got, want = cached(x), fresh(x)
    assert got.dtype == want.dtype and torch.equal(got, want)


# A module class, two configurations that differ in one thing, the buffers
# that must differ and those that are functions of neither difference.
NONE = ("none", {})
KEY_CASES = {
    "bs_encoder": (BandEncoder, _cfg(64, 128, bs=1), _cfg(64, 128, bs=4),
                   {"fac_t"}, {"zigzag", "mul", "div", "mask"}),
    # The combined branch's operator is a function of bs; the kernel
    # branch's is not (K4 writes each pixel to its bs x bs places).
    "bs_decoder": (BandDecoder, _cfg(64, 128, bs=1, quant=FRACTIONAL),
                   _cfg(64, 128, bs=4, quant=FRACTIONAL), {"op_t"}, set()),
    "bs_kernel_decoder": (BandDecoder, _cfg(48, 96, bs=1),
                          _cfg(48, 96, bs=4), set(), {"op_t", "deq"}),
    # Padded at bs 4, the encode's factor is the bs = 1 one.
    "effective_bs": (BandEncoder, _cfg(48, 96, bs=1), _cfg(48, 96, bs=4),
                     set(), {"fac_t", "zigzag", "mul", "div", "mask"}),
    "transform": (BandDecoder,
                  _cfg(48, 96, transform="DCT", quant=FRACTIONAL),
                  _cfg(48, 96, transform="DFT", quant=FRACTIONAL),
                  {"op_t"}, set()),
    "d": (BandDecoder, _cfg(48, 96, quant=NONE),
          _cfg(48, 96, d=24, quant=NONE), {"op_t", "deq"}, set()),
    "quantizer": (BandDecoder,
                  _cfg(48, 96, quant=("divide", {"divisor": 40})),
                  _cfg(48, 96, quant=("divide", {"divisor": 1000})),
                  {"deq"}, {"op_t"}),
    "quantizer_kind": (BandDecoder, _cfg(48, 96), _cfg(48, 96, quant=NONE),
                       {"deq"}, {"op_t"}),
    "discard_keep": (BandEncoder,
                     _cfg(48, 96, quant=("discard", {"keep": 2})),
                     _cfg(48, 96, quant=("discard", {"keep": 3})),
                     {"mul", "div", "mask"}, {"fac_t", "zigzag"}),
    "frame_size": (BandDecoder, _cfg(48, 96), _cfg(96, 144), set(),
                   {"op_t", "deq"}),
}


@pytest.mark.parametrize("what", sorted(KEY_CASES))
def test_keys_differing_in_one_thing_share_nothing_of_it(what):
    cls, a_cfg, b_cfg, differ, shared = KEY_CASES[what]
    a, b = _buffers(cls(a_cfg)), _buffers(cls(b_cfg))
    assert differ | shared <= set(a) & set(b)
    for k in differ:
        assert a[k] is not b[k], k
    for k in shared:
        assert a[k] is b[k], k


@pytest.mark.parametrize("transform", ["DCT", "DFT"])
def test_kernel_branch_takes_the_chains_decode_operator(transform):
    """The kernel branch holds the d*d x d*d decode operator, the very
    entry the chain branch uses, at every block size: K4 inflates as it
    stores, so no (d*bs)**2-column operator is built for it."""
    fn = T.decode_operator if transform == "DCT" else T.dft_decode_operator
    chain = BandDecoder(_cfg(40, 56, bs=2, d=8, transform=transform,
                             quant=FRACTIONAL))
    assert chain.branch == "chain"
    for bs in (1, 2, 4):
        for h, w in ((64, 128), (40, 56)):
            kernel = BandDecoder(_cfg(h, w, bs=bs, d=8, transform=transform))
            assert kernel.branch == "kernel"
            assert kernel.op_t is chain.op_t
    assert chain.op_t.shape == (64, 64)
    np.testing.assert_array_equal(chain.op_t.numpy(),
                                  fn(8).T.astype(np.float32))
    assert (fn, 8, F32, torch.device("cpu")) in band._CACHE._entries
    assert not any(k[0] is T.combined_decode_operator
                   for k in band._CACHE._entries)


def test_dtype_is_part_of_the_key():
    cfg = _cfg(48, 96)
    a, b = _buffers(BandEncoder(cfg, F32)), _buffers(BandEncoder(cfg, F64))
    for k in ("mul", "div", "mask"):
        assert a[k] is not b[k] and (a[k].dtype, b[k].dtype) == (F32, F64)


def test_device_is_part_of_the_key():
    """One key on two devices: two entries, each on its device."""
    made = []

    def make():
        made.append(1)
        return torch.arange(4.0)

    cpu, meta = torch.device("cpu"), torch.device("meta")
    (a,), built_a = band._CACHE.fetch(cpu, [(("t",), make)])
    (b,), built_b = band._CACHE.fetch(meta, [(("t",), make)])
    (c,), built_c = band._CACHE.fetch(cpu, [(("t",), make)])
    assert (built_a, built_b, built_c) == (True, True, False)
    assert a.device == cpu and b.device == meta and c is a
    assert len(made) == 2


@pytest.mark.parametrize("first", ["share", "whole"])
def test_share_keeps_the_whole_images_branch_beside_its_own_geometry(
        first):
    """A share above the padded edge of a 40 x 64 image has the geometry
    of a 32 x 64 image, divisible on its own.  Built next to that image,
    in either order, the share still runs the padded image's branches and
    answers as it does with the cache cleared."""
    image = _cfg(40, 64, quant=FRACTIONAL)
    share, _, _ = sharded._row_config(image, 0, 2)
    alone = _cfg(share.height, share.width, quant=FRACTIONAL)
    assert (BandEncoder(alone).branch, BandDecoder(alone).branch) == \
        ("separable", "combined")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 256, (3, share.height, 64),
                                      np.uint8))

    def share_answers():
        enc = BandEncoder(share, _image=image)
        dec = BandDecoder(share, _image=image)
        assert (enc.branch, dec.branch) == ("sep_pad", "chain")
        return enc(x), dec(enc(x))

    band._CACHE.clear()
    want = share_answers()
    band._CACHE.clear()
    if first == "whole":
        BandDecoder(alone)(BandEncoder(alone)(x))
    got = share_answers()
    if first == "share":
        BandDecoder(alone)(BandEncoder(alone)(x))
        got = share_answers()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _fill(cache, device, names, n=256):
    """One float32 entry of ``n`` values per name, in order."""
    for name in names:
        cache.fetch(device, [((name,), lambda: torch.zeros(n))])


def _held(cache, device):
    return [k[0] for k, e in cache._entries.items() if e.device == device]


def test_bound_evicts_the_least_recently_used(monkeypatch):
    monkeypatch.setattr(band, "_CACHE_BYTES", 3 * 1024)
    cache, cpu = band._BufferCache(), torch.device("cpu")
    _fill(cache, cpu, "abc")
    assert _held(cache, cpu) == ["a", "b", "c"]
    _fill(cache, cpu, "a")                   # a hit: now the newest
    _fill(cache, cpu, "d")
    assert _held(cache, cpu) == ["c", "a", "d"]


def test_bound_keeps_the_newest_even_alone_over_it(monkeypatch):
    monkeypatch.setattr(band, "_CACHE_BYTES", 1024)
    cache, cpu = band._BufferCache(), torch.device("cpu")
    _fill(cache, cpu, "ab")
    assert _held(cache, cpu) == ["b"]
    _fill(cache, cpu, "c", n=10_000)
    assert _held(cache, cpu) == ["c"]


def test_bound_is_per_device(monkeypatch):
    monkeypatch.setattr(band, "_CACHE_BYTES", 2 * 1024)
    cache = band._BufferCache()
    cpu, meta = torch.device("cpu"), torch.device("meta")
    _fill(cache, cpu, "ab")
    _fill(cache, meta, "xyz")
    assert _held(cache, cpu) == ["a", "b"]
    assert _held(cache, meta) == ["y", "z"]


def test_real_operators_fit_the_bound():
    """Several d 24 combined decode operators (9,216 x 576 f32 at bs 4, the
    largest buffers) stay together."""
    ops = [BandDecoder(_cfg(96, 96, bs=bs, d=24, transform=t,
                            quant=FRACTIONAL)).op_t
           for t in ("DCT", "DFT") for bs in (4, 2)]
    assert ops[0].shape == (576, 9216)
    assert len({id(op) for op in ops}) == 4
    held = [e.tensor for e in band._CACHE._entries.values()]
    assert all(any(t is op for t in held) for op in ops)


def test_cached_tensors_are_not_written_by_decodes_and_encodes():
    cfg = _cfg(40, 56, bs=2, d=8)
    img = np.random.default_rng(5).integers(0, 256, (40, 56, 3), np.uint8)
    blob = J.compress_ycbcr(img, cfg, device="cpu")
    before = {k: (e.tensor, e.tensor.clone())
              for k, e in band._CACHE._entries.items()}
    assert before
    for _ in range(2):
        J.decompress_to_ycbcr(blob, device="cpu", scan="host")
        J.decompress_to_device(blob, device="cpu", scan="device")
        J.decompress_many([blob, blob], device="cpu")
        J.compress_many([img, img], cfg, device="cpu")
        J.decompress_band(J.compress_band(img[:, :, 0], cfg, device="cpu"),
                          cfg, device="cpu")
    for k, (t, copy) in before.items():
        assert band._CACHE._entries[k].tensor is t
        assert torch.equal(t, copy), k


def test_to_moves_a_cached_module_and_leaves_the_cache():
    cfg = _cfg(48, 96, quant=FRACTIONAL)
    dec = BandDecoder(cfg)
    cached = dec.op_t
    moved = dec.to(F64)
    assert moved.op_t.dtype == F64 and cached.dtype == F32
    again, counts = _recorded(lambda: BandDecoder(cfg))
    assert again.op_t is cached and counts == {"band.cache_hits": 1}


def test_threads_building_together_make_one_entry():
    """More threads than cores and a short switch interval, all missing
    together: one build, one entry, every module on its tensors."""
    cfg = _cfg(96, 96, bs=4, d=24, quant=NONE)
    n = 2 * (os.cpu_count() or 1) + 3
    start = threading.Barrier(n)
    got = [None] * n

    def build(i):
        start.wait()
        got[i] = BandDecoder(cfg)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    P.start_recording()
    try:
        ts = [threading.Thread(target=build, args=(i,)) for i in range(n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
    finally:
        P.stop_recording()
        sys.setswitchinterval(old)
    assert all(m.op_t is got[0].op_t and m.deq is got[0].deq for m in got)
    assert len(band._CACHE._entries) == 2
    assert P.recorded().counts == {"band.builds": 1, "band.cache_hits": n - 1}
    assert sum(s.name == "band.build" for s in P.recorded().spans) == 1
