"""The plain reference against jpeg_tpu_torch's f32 path on small frames on
the CPU (this test may import both; the reference imports nothing of the
program), and its codec against the program's wire format."""
import numpy as np
import pytest
import torch

import jpeg_tpu_torch as jt
from jpeg_tpu_torch.entropy import numpy_codec
from jpeg_tpu_torch.ops import transform as PT

from port_bench import program
from port_bench.frames import synth_frames
from port_bench.reference import codec as R

SETTINGS = {
    "qtable_d8": {"block_size": 4, "dct_size": 8, "transform": "DCT",
                  "quantization": {"name": "qtable", "params": {}}},
    "divide1000_d24": {"block_size": 4, "dct_size": 24, "transform": "DCT",
                       "quantization": {"name": "divide",
                                        "params": {"divisor": 1000}}},
    "none_dft_bs3": {"block_size": 3, "dct_size": 8, "transform": "DFT",
                     "quantization": {"name": "none", "params": {}}},
}
SIZES = {"qtable_d8": (54, 70), "divide1000_d24": (100, 136),
         "none_dft_bs3": (40, 52)}


def _case(name, seed):
    h, w = SIZES[name]
    codec = R.Codec.from_settings(SETTINGS[name], h, w)
    frame = synth_frames(1, h, w, seed, "cpu")[0]
    cfg = program.configuration(jt, SETTINGS[name], h, w)
    return codec, frame, cfg


def _bad(got, want, ties):
    diff = got.to(torch.int64) - want.to(torch.int64)
    return int(((diff != 0) & (~ties | (diff.abs() > 1))).sum())


@pytest.mark.parametrize("seed", [3, 2 ** 32 + 1])
@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_program_containers_within_tie_contract(name, seed):
    codec, frame, cfg = _case(name, seed)
    blob = jt.compress_ycbcr(frame.numpy(), cfg, device="cpu")
    want, ties = R.encode_levels(codec, frame)
    got = R.decode_container_levels(codec, blob)
    assert _bad(got, want, ties) == 0
    # and the reference's own container reads back as its levels
    ref_blob = R.encode_container(codec, frame)
    assert torch.equal(R.decode_container_levels(codec, ref_blob), want)


@pytest.mark.parametrize("seed", [4, 2 ** 31 + 9])
@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_program_planes_within_tie_contract(name, seed):
    codec, frame, _ = _case(name, seed)
    blob = R.encode_container(codec, frame)
    want, ties = R.decode_planes(codec, R.decode_container_levels(codec,
                                                                  blob))
    got = jt.decompress_to_ycbcr(blob, device="cpu")
    assert got.shape == (codec.height, codec.width, 3)
    assert _bad(torch.from_numpy(got).permute(2, 0, 1), want, ties) == 0


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_header_bytes_equal_the_programs(name):
    codec, _, cfg = _case(name, 0)
    bands = [b"\x00" * codec.num_blocks] * 3
    assert R.pack_container(codec, bands) == jt.generate_data(
        cfg, jt.CompressedData(*bands))
    fields, got = R.read_container(R.pack_container(codec, bands))
    assert R.header_matches(codec, fields) and got == bands


@pytest.mark.parametrize("d", [3, 8, 24])
def test_operators_equal_the_programs(d):
    assert R.zigzag_order(d).tolist() == PT.zigzag_permutation(d).tolist()
    for transform, enc, dec in (
            ("DCT", PT.encode_operator, PT.decode_operator),
            ("DFT", PT.dft_encode_operator, PT.dft_decode_operator)):
        codec = R.Codec(8, 8, 1, d, transform)
        np.testing.assert_allclose(R.encode_operator(codec).numpy(), enc(d),
                                   atol=1e-12)
        np.testing.assert_allclose(R.decode_operator(codec).numpy(), dec(d),
                                   atol=1e-12)


def _levels(seed, n, L):
    rng = np.random.default_rng(seed)
    lv = rng.integers(-40, 41, (n, L)) * (rng.random((n, L)) < 0.15)
    lv[0] = 0                                   # an all-EOB block
    lv[1, -1] = R.MAX_AMP                       # a long zero run, max size
    lv[2, :3] = (-R.MAX_AMP, 1, -1)
    return lv.astype(np.int64)


@pytest.mark.parametrize("L", [9, 64, 576])
def test_entropy_codec_equals_the_programs(L):
    lv = _levels(L, 37, L)
    ref = R.entropy_encode(torch.from_numpy(lv))
    assert ref == numpy_codec.encode_levels(lv.astype(np.int32))
    assert R.entropy_decode(ref, 37, L).numpy().tolist() == lv.tolist()


@pytest.mark.parametrize("cut", ["truncated", "trailing", "garbage",
                                 "short"])
def test_entropy_decoder_rejects_bad_streams(cut):
    lv = _levels(1, 12, 64)
    s = R.entropy_encode(torch.from_numpy(lv))
    bad = {"truncated": s[:-1], "trailing": s + b"\x00",
           "garbage": bytes([0x5A]) * len(s), "short": s[:5]}[cut]
    with pytest.raises(R.StreamError):
        R.entropy_decode(bad, 12, 64)
    with pytest.raises((jt.BadStreamError, jt.BadRleCodeError)):
        numpy_codec.decode_levels(bad, 12, 64)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -12, -3.0000002])
    got = R.to_tf32(x)
    assert got.tolist() == [1.0, 1 + 2 ** -10, 1 + 2 ** -10, -3.0]
    bits = got.view(torch.int32) & 0x1FFF
    assert int(bits.abs().sum()) == 0


def test_frames_depend_on_the_seed_alone():
    a = synth_frames(2, 16, 24, 2 ** 31 + 3, "cpu")
    b = synth_frames(2, 16, 24, 2 ** 31 + 3, "cpu")
    c = synth_frames(2, 16, 24, 2 ** 31 + 4, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a[0], a[1])
    assert a.dtype == torch.uint8 and a.shape == (2, 16, 24, 3)
