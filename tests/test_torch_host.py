"""jpeg_tpu_torch host layer vs jpeg_tpu: configuration, container, host
entropy codecs.

These modules are pure Python / NumPy / C++ in both packages, so the
contract is exact equality: same Configuration, same bytes, same levels.
"""
import os

import numpy as np
import pytest
import torch

import jpeg_tpu.container as jcontainer
import jpeg_tpu.entropy as jentropy
from jpeg_tpu.config import BadRleCodeError as JBadRleCodeError
from jpeg_tpu.config import BadStreamError as JBadStreamError
from jpeg_tpu.config import Configuration as JConfiguration
from jpeg_tpu.config import QuantizationMethod as JQuantizationMethod

import jpeg_tpu_torch.container as tcontainer
import jpeg_tpu_torch.entropy as tentropy
from jpeg_tpu_torch.config import (BadRleCodeError, BadStreamError,
                                   Configuration, QuantizationMethod)
from jpeg_tpu_torch.entropy import native_codec, numpy_codec

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GOLDENS = sorted(f[:-3] for f in os.listdir(GOLDEN) if f.endswith(".jc"))


def _golden(name):
    with open(os.path.join(GOLDEN, f"{name}.jc"), "rb") as f:
        return f.read()


def _config_fields(cfg):
    q = cfg.quantization
    return (cfg.width, cfg.height, cfg.block_size, cfg.dct_size,
            cfg.transform, q.name, q.params, q.to_json())


def _random_levels(seed, n, L, density=0.2, amp=16383):
    rng = np.random.default_rng(seed)
    lv = np.where(rng.random((n, L)) < density,
                  rng.integers(-amp, amp + 1, (n, L)), 0)
    lv[rng.random(n) < 0.2] = 0          # some bare-EOB blocks
    return lv.astype(np.int32)


BACKENDS = {"numpy": numpy_codec, "native": native_codec}


def test_six_goldens_present():
    assert len(GOLDENS) == 6


@pytest.mark.parametrize("name", GOLDENS)
def test_golden_container_parses_identically(name):
    """read_data gives the same Configuration and band streams, and
    create_header / generate_data rebuild the same bytes."""
    blob = _golden(name)
    tcfg, tdata = tcontainer.read_data(blob)
    jcfg, jdata = jcontainer.read_data(blob)
    assert _config_fields(tcfg) == _config_fields(jcfg)
    assert (tdata.y, tdata.cb, tdata.cr) == (jdata.y, jdata.cb, jdata.cr)
    assert tcontainer.create_header(tcfg) == jcontainer.create_header(jcfg)
    assert tcontainer.generate_data(tcfg, tdata) == blob


def test_configuration_geometry_and_json_match():
    for kw in (dict(width=37, height=23, block_size=4),
               dict(width=50, height=30, block_size=5, dct_size=24),
               dict(width=8, height=8, block_size=1, dct_size=4)):
        for q in (("none", {}), ("discard", {"keep": 3}),
                  ("divide", {"divisor": 7}), ("qtable", {})):
            if q[0] == "qtable" and kw.get("dct_size", 8) != 8:
                continue
            t = Configuration(quantization=QuantizationMethod(q[0], **q[1]),
                              **kw)
            j = JConfiguration(quantization=JQuantizationMethod(q[0], **q[1]),
                               **kw)
            for attr in ("padded_width", "padded_height", "coeff_width",
                         "coeff_height", "blocks_wide", "blocks_high",
                         "num_blocks"):
                assert getattr(t, attr) == getattr(j, attr), attr
            assert t.quantization.to_json() == j.quantization.to_json()


def test_native_codec_builds_inside_the_repo():
    assert native_codec.available()
    so = native_codec._so_path()
    assert so.startswith(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "build", "native"))


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("seed,n,L,density", [
    (0, 200, 64, 0.2), (1, 1, 64, 0.5), (2, 333, 16, 0.3),
    (3, 64, 576, 0.02)])
def test_entropy_backends_equal_jpeg_tpu(backend, seed, n, L, density):
    """encode_levels / decode_levels / scan_offsets of each port backend
    equal jpeg_tpu.entropy's (which picks its own best backend)."""
    codec = BACKENDS[backend]
    lv = _random_levels(seed, n, L, density)
    data = codec.encode_levels(lv)
    assert data == jentropy.encode_levels(lv)
    np.testing.assert_array_equal(codec.decode_levels(data, n, L), lv)
    np.testing.assert_array_equal(codec.decode_levels(data, n, L),
                                  jentropy.decode_levels(data, n, L))
    np.testing.assert_array_equal(codec.scan_offsets(data, n, L),
                                  jentropy.scan_offsets(data, n, L))


def test_entropy_dispatch_equals_jpeg_tpu():
    lv = _random_levels(5, 120, 64)
    data = tentropy.encode_levels(lv)
    assert data == jentropy.encode_levels(lv)
    np.testing.assert_array_equal(tentropy.decode_levels(data, 120, 64), lv)
    np.testing.assert_array_equal(tentropy.scan_offsets(data, 120, 64),
                                  jentropy.scan_offsets(data, 120, 64))


def test_encode_levels_range_guard():
    """Wide integer levels are range-checked before the int32 narrowing."""
    lv = np.zeros((2, 64), np.int64)
    lv[1, 3] = 2 ** 32 + 5                    # would wrap to 5 in int32
    with pytest.raises(BadRleCodeError):
        tentropy.encode_levels(lv)
    with pytest.raises(TypeError):
        tentropy.encode_levels(np.zeros((1, 64), np.float32))


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_stream_errors_match(backend):
    """Malformed streams raise the same exception class in both packages."""
    codec = BACKENDS[backend]
    lv = _random_levels(7, 10, 64)
    data = codec.encode_levels(lv)
    for bad in (data[:-3], data + b"\x00", b"\x35" + data[1:]):
        with pytest.raises((JBadStreamError, JBadRleCodeError)) as want:
            jentropy.scan_offsets(bad, 10, 64)
        with pytest.raises((BadStreamError, BadRleCodeError)) as got:
            codec.scan_offsets(bad, 10, 64)
        assert type(got.value).__name__ == type(want.value).__name__
