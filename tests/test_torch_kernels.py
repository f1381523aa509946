"""jpeg_tpu_torch kernels' plain PyTorch versions vs jpeg_tpu.

On the CPU each kernel wrapper runs its plain version (the CUDA kernels
run only on a GPU, where chip_smoke.py holds each against its plain
version).  Tolerances:

* K1-K3 (bit manipulation) are exact: the stream bytes must equal the host
  codec's (``jpeg_tpu.entropy.encode_levels``), block byte counts
  ``device_codec.block_bytes_of``'s, and decoded levels
  ``jpeg_tpu.entropy.decode_levels``'.  The interpret-mode Pallas K1-K3
  take tens of seconds per call, so the host codec is the reference.
* K4 (an f32 product then round) equals the Pallas ``decode_blocks`` in
  interpret mode except +-1 where ``decode_reference_and_ties`` marks a
  provable .5 tie (``jpeg_tpu/utils/parity.py``; f32 summation orders
  differ); with ``bs``, on the d*d operator, it equals the Pallas kernel on
  the combined operator that computes every replica, the same way.
"""
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jpeg_tpu.entropy as jentropy
from jpeg_tpu.entropy import device_codec as JDC
from jpeg_tpu.ops import pallas_kernels as PK
from jpeg_tpu.ops import transform as JT
from jpeg_tpu.utils import parity as jparity
from jpeg_tpu.config import Configuration as JConfiguration
from jpeg_tpu.config import QuantizationMethod as JQuantizationMethod

from jpeg_tpu_torch.config import QuantizationMethod
from jpeg_tpu_torch.entropy import device_codec as DC
from jpeg_tpu_torch.ops import kernels as K
from jpeg_tpu_torch.ops import quantize as Q

torch.set_num_threads(2)


def _edge_levels(case):
    """(N, 64) int32 levels for the codec's edge cases."""
    rng = np.random.default_rng(11)
    if case == "all_zero":                      # bare EOB blocks
        return np.zeros((9, 64), np.int32)
    if case == "max_amp":
        lv = rng.choice([-16383, 16383, 8192, -1, 1], (17, 64))
        lv[::3, 1::2] = 0
        return lv.astype(np.int32)
    if case == "long_runs":                     # zero runs of 15/16/30/63
        lv = np.zeros((8, 64), np.int32)
        lv[0, 15] = 5
        lv[1, 16] = -7
        lv[2, 30] = 16383
        lv[3, 63] = -16383
        lv[4, [0, 16, 47, 63]] = [1, -2, 3, -4]     # runs 15, 30, 15
        lv[5, [15, 31, 47, 63]] = 9                 # runs 15, 15, 15, 15
        lv[6, 0] = 1
        lv[7, 63] = 1
        return lv
    if case == "n1":
        return np.array([[3] + [0] * 62 + [-2]], np.int32)
    if case == "n_ragged":                      # N not a multiple of a tile
        lv = np.where(rng.random((1031, 64)) < 0.12,
                      rng.integers(-600, 601, (1031, 64)), 0)
        lv[rng.random(1031) < 0.1] = 0
        return lv.astype(np.int32)
    raise ValueError(case)


EDGE_CASES = ["all_zero", "max_amp", "long_runs", "n1", "n_ragged"]


def _row_words(lv):
    """The sized row width: the longest block's bytes in 4-byte words."""
    return -(-int(DC.block_bytes_of(torch.from_numpy(lv)).max()) // 4)


def _encode(lv):
    t = torch.from_numpy(lv)
    rows, bb = DC.encode_rows(t, _row_words(lv))
    total = int(bb.to(torch.int64).sum())
    return rows, bb, DC.compact_rows(rows, bb, total)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_k1_k2_stream_equals_host_encoder(case):
    lv = _edge_levels(case)
    rows, bb, buf = _encode(lv)
    assert buf.numpy().tobytes() == jentropy.encode_levels(lv)
    np.testing.assert_array_equal(
        bb.numpy(), np.asarray(JDC.block_bytes_of(jnp.asarray(lv))))
    np.testing.assert_array_equal(bb.numpy(),
                                  DC.block_bytes_of(torch.from_numpy(lv)))


@pytest.mark.parametrize("case", EDGE_CASES)
def test_k1_rows_are_top_justified_block_streams(case):
    """Row i holds exactly block i's bytes, big-endian, zero-padded."""
    lv = _edge_levels(case)
    W = _row_words(lv)
    rows, bb, _ = _encode(lv)
    assert rows.shape == (lv.shape[0], W) and rows.dtype == torch.int32
    raw = rows.numpy().astype(">u4").tobytes()
    for i in range(lv.shape[0]):
        row = raw[4 * W * i:4 * W * (i + 1)]
        n = int(bb[i])
        assert row[:n] == jentropy.encode_levels(lv[i:i + 1])
        assert row[n:] == bytes(4 * W - n)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_k3_equals_host_decoder(case):
    lv = _edge_levels(case)
    data = jentropy.encode_levels(lv)
    n = lv.shape[0]
    starts = torch.from_numpy(jentropy.scan_offsets(data, n, 64).astype(
        np.int64))
    stream = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    got = DC.decode_stream(stream, starts, 64)
    np.testing.assert_array_equal(got.numpy(),
                                  jentropy.decode_levels(data, n, 64))


def test_k1_handles_zero_runs_beyond_four_chains():
    """L > 75: a zero run of more than 74 needs more than four chain bytes
    (the TPU kernel's n_sub appends); the port writes any number."""
    L = 144
    lv = np.zeros((4, L), np.int32)
    lv[0, 143] = 1                              # run of 143: 9 chains
    lv[1, [0, 100]] = [-5, 16383]               # run of 99: 6 chains
    lv[2, 75] = 2
    rows, bb, buf = _encode(lv)
    assert buf.numpy().tobytes() == jentropy.encode_levels(lv)
    data = buf.numpy().tobytes()
    starts = torch.from_numpy(jentropy.scan_offsets(data, 4, L).astype(
        np.int64))
    got = DC.decode_stream(torch.frombuffer(bytearray(data),
                                            dtype=torch.uint8), starts, L)
    np.testing.assert_array_equal(got.numpy(), lv)


def test_k2_cap_bounds_the_write():
    lv = _edge_levels("n_ragged")
    rows, bb, full = _encode(lv)
    total = full.shape[0]
    wider = K.deposit_rows(rows, bb, total + 100)
    assert torch.equal(wider[:total], full) and not wider[total:].any()
    short = K.deposit_rows(rows, bb, total - 50)
    assert torch.equal(short, full[:total - 50])


def _bb_sum(t):
    return DC.block_bytes_of(t).to(torch.int64).sum()


def test_sized_encode_overflow_raises():
    """A row width below the longest block sets the overflow flag, zeroes
    the buffer, and the host check raises."""
    lv = _edge_levels("max_amp")
    t = torch.from_numpy(lv)
    mb = int(DC.block_bytes_of(t).max())
    buf, bb, bad = DC.encode_stream_sized(t, -(-mb // 4), int(_bb_sum(t)))
    DC.check_sized_ok(bad)
    assert buf.numpy().tobytes() == jentropy.encode_levels(lv)
    for W, cap in ((mb // 4 - 1, int(_bb_sum(t))), (-(-mb // 4),
                                                  int(_bb_sum(t)) - 1)):
        buf, _, bad = DC.encode_stream_sized(t, W, cap)
        assert bool(bad) and not buf.any()
        with pytest.raises(ValueError, match="overflow"):
            DC.check_sized_ok(bad)


def test_k4_equals_pallas_interpret_except_ties():
    """Plain K4 vs the Pallas decode kernel (interpret mode) on real levels
    of a 32x48 image (qtable, bs 2): equal except +-1 at provable ties."""
    cfg = JConfiguration(width=48, height=32, block_size=2, dct_size=8,
                         quantization=JQuantizationMethod("qtable"))
    rng = np.random.default_rng(3)
    y, x = np.mgrid[0:32, 0:48]
    band = np.clip(128 + 80 * np.sin(x / 5.0) * np.cos(y / 7.0)
                   + 20 * rng.standard_normal((32, 48)), 0, 255)
    ref_lv, _ = jparity.encode_reference_and_ties(cfg, band)
    lv = ref_lv.astype(np.int32)                    # (N, 64)
    op = JT.combined_decode_operator(8, 2)          # (256, 64)
    deq = Q.qtable_zigzag(8).astype(np.int32)
    got = K.decode_blocks(torch.from_numpy(lv),
                          torch.from_numpy(op.T.astype(np.float32)).contiguous(),
                          torch.from_numpy(deq))
    want = np.asarray(PK.decode_blocks(
        jnp.asarray(lv), jnp.asarray(op.T, jnp.float32), jnp.asarray(deq),
        interpret=True))
    assert got.dtype == torch.uint8 and got.shape == want.shape

    def plane(pix):
        return np.asarray(pix).reshape(2, 3, 16, 16).transpose(0, 2, 1, 3) \
            .reshape(32, 48)

    _, ties = jparity.decode_reference_and_ties(cfg, lv)
    jparity.assert_tie_equal(plane(got.numpy()), plane(want), ties, "K4")


@pytest.mark.parametrize("d,bs,tr,qname", [
    (8, 2, "DCT", "qtable"), (8, 4, "DFT", "qtable"), (3, 3, "DCT", "none"),
    (24, 2, "DCT", "divide")])
def test_k4_inflate_equals_pallas_on_the_combined_operator_except_ties(
        d, bs, tr, qname):
    """Plain K4 on the d*d decode operator with ``bs`` vs the Pallas
    ``decode_blocks`` (interpret mode) on the ((d*bs)**2, d*d) combined
    operator, which computes every replica: equal except +-1 at provable
    ties, each pixel's replicas equal to one another."""
    qp = {"divisor": 1000} if qname == "divide" else {}
    D = d * bs
    cfg = JConfiguration(width=3 * D, height=2 * D, block_size=bs,
                         dct_size=d, transform=tr,
                         quantization=JQuantizationMethod(qname, **qp))
    L = d * d
    rng = np.random.default_rng(d * 10 + bs)
    lv = np.where(rng.random((cfg.num_blocks, L)) < 0.3,
                  rng.integers(-30, 31, (cfg.num_blocks, L)), 0)
    lv[:, 0] = rng.integers(-60, 61, cfg.num_blocks)
    lv = lv.astype(np.int32)
    dec = JT.decode_operator(d) if tr == "DCT" else JT.dft_decode_operator(d)
    deq = Q.dequant_int_vector(QuantizationMethod(qname, **qp), d)
    deq = deq.astype(np.int32)
    got = K.decode_blocks(torch.from_numpy(lv),
                          torch.from_numpy(dec.T.astype(np.float32)),
                          torch.from_numpy(deq), bs=bs).numpy()
    op = JT.combined_decode_operator(d, bs, tr)        # ((d*bs)^2, L)
    want = np.asarray(PK.decode_blocks(
        jnp.asarray(lv), jnp.asarray(op.T, jnp.float32), jnp.asarray(deq),
        interpret=True))
    assert got.dtype == np.uint8 and got.shape == want.shape == (
        cfg.num_blocks, D * D)
    blocks = got.reshape(-1, d, bs, d, bs)
    assert (blocks == blocks[:, :, :1, :, :1]).all()

    def plane(pix):
        return np.asarray(pix).reshape(2, 3, D, D).transpose(0, 2, 1, 3) \
            .reshape(2 * D, 3 * D)

    _, ties = jparity.decode_reference_and_ties(cfg, lv)
    jparity.assert_tie_equal(plane(got), plane(want), ties, "K4 inflate")


def test_k4_checks_its_block_size():
    """``bs`` is an int of at least 1, and above 1 the operator's width a
    square; at bs 1 any width is taken.  The plain version checks the
    same; neither launches anything on the CPU."""
    lv = torch.ones((3, 16), dtype=torch.int32)
    deq = torch.ones(16, dtype=torch.int32)
    op = torch.full((16, 36), 0.25)
    before = K.launch_counts()
    for fn in (K.decode_blocks, K.decode_blocks_plain):
        for bad in (0, -1, 2.0, None):
            with pytest.raises(ValueError, match="bs must be an int"):
                fn(lv, op, deq, bs=bad)
        with pytest.raises(ValueError, match=r"d\*d"):
            fn(lv, op[:, :35].contiguous(), deq, bs=2)
        assert fn(lv, op[:, :35].contiguous(), deq).shape == (3, 35)
        out = fn(lv, op, deq, bs=3)
        assert out.shape == (3, 36 * 9) and out.dtype == torch.uint8
        assert (out == 4).all()
    assert K.launch_counts() == before


def test_k4_rounds_half_to_even_and_clamps():
    """Exact .5 values round to even (rintf / torch.round), not away from
    zero; results clamp to [0, 255]."""
    lv = torch.tensor([[1], [3], [5], [-1], [600], [7]], dtype=torch.int32)
    op_t = torch.tensor([[0.5]], dtype=torch.float32)
    deq = torch.tensor([1], dtype=torch.int32)
    got = K.decode_blocks(lv, op_t, deq).flatten().tolist()
    assert got == [0, 2, 2, 0, 255, 4]


def test_wrappers_check_inputs_and_never_fall_back():
    lv = torch.zeros((4, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        K.encode_stream_rows(lv.to(torch.int64), 4)
    with pytest.raises(ValueError, match="contiguous"):
        K.encode_stream_rows(torch.zeros((64, 4), dtype=torch.int32).t(), 4)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        K.encode_stream_rows(lv.to("meta"), 4)
    with pytest.raises(ValueError, match="different devices"):
        K.deposit_rows(torch.zeros((4, 2), dtype=torch.int32),
                       torch.zeros(4, dtype=torch.int32, device="meta"), 8)
    before = K.launch_counts()
    K.decode_stream_blocks(torch.zeros(4, dtype=torch.uint8),
                           torch.zeros(1, dtype=torch.int64), 64)
    K.scan_walk(torch.zeros(4, dtype=torch.uint8), 4, 64)
    K.chase_starts(torch.zeros(6, dtype=torch.int32), 0, 0, 3)
    K.chase_starts_multi(torch.zeros(6, dtype=torch.int32),
                         torch.zeros(2, dtype=torch.int64),
                         torch.zeros(2, dtype=torch.int64), 3)
    assert K.launch_counts() == before      # the plain version launches nothing
    assert set(before) == {"encode_stream_rows", "encode_stream_rows_tables",
                           "deposit_rows", "decode_stream_blocks",
                           "decode_blocks", "encode_blocks", "scan_walk",
                           "scan_walk_capped", "scan_walk_resume",
                           "chase_starts", "chase_starts_multi"}
    with pytest.raises(ValueError, match="n_bytes"):
        K.scan_walk(torch.zeros(4, dtype=torch.uint8), 5, 64)
    with pytest.raises(ValueError, match="int32"):
        K.chase_starts(torch.zeros(6, dtype=torch.int64), 0, 0, 3)
    with pytest.raises(ValueError, match="chain starts"):
        K.chase_starts_multi(torch.zeros(6, dtype=torch.int32),
                             torch.zeros(2, dtype=torch.int64),
                             torch.zeros(3, dtype=torch.int64), 3)
    with pytest.raises(ValueError, match="different devices"):
        K.chase_starts_multi(torch.zeros(6, dtype=torch.int32),
                             torch.zeros(2, dtype=torch.int64, device="meta"),
                             torch.zeros(2, dtype=torch.int64), 3)


def test_kernel_build_is_keyed_by_source_hash():
    """The library path hashes every csrc file and the nvcc flags, so an
    edited kernel never loads a stale build."""
    path = K.library_path()
    assert path.startswith(K.BUILD_ROOT)
    assert "-gencode" in K.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in \
        K.NVCC_FLAGS
    assert [os.path.basename(p) for p in K._sources()] == [
        "chase.cu", "compact.cu", "decode_blocks.cu", "decode_stream.cu",
        "encode_blocks.cu", "encode_stream.cu", "encode_tables.cu",
        "scan_walk.cu"]
    # the two encode kernels share one bit writer, the two products one
    # tensor-core product
    for src, header in (("encode_stream.cu", "bit_writer.cuh"),
                        ("encode_tables.cu", "bit_writer.cuh"),
                        ("decode_blocks.cu", "tc_product.cuh"),
                        ("encode_blocks.cu", "tc_product.cuh")):
        with open(os.path.join(K.CSRC, src)) as f:
            assert f'#include "{header}"' in f.read(), src
    assert sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(K.CSRC, "*.cuh"))) == [
        "bit_writer.cuh", "common.cuh", "tc_product.cuh"]
