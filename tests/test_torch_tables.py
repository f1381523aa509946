"""jpeg_tpu_torch's tables encode path (``enc="tables"``: unit-group tables,
then kernel K9) vs jpeg_tpu.

On the CPU each kernel wrapper runs its plain PyTorch version (the CUDA
kernels run only on a GPU, where chip_smoke.py holds each against its plain
version).  Everything here is bit manipulation, so every check is exact:

* ``device_codec._unit_groups`` equals ``jpeg_tpu``'s (cbits, vhi, vlo and
  block bytes) bit for bit, at L = 16, 64 and 144 (past L = 75 too, where
  both give the same unusable values for runs of more than 4 chains).
* Plain K9 rows equal the Pallas ``encode_stream_rows`` in interpret mode
  (L = 16: the interpreted kernel costs seconds per slot sweep), and plain
  K1's rows of the same levels.
* Containers with ``enc="tables"`` equal ``enc="lv"``'s and, in the f64
  parity mode, ``jpeg_tpu.compress_ycbcr``'s.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jpeg_tpu
import jpeg_tpu.container as jcontainer
import jpeg_tpu.entropy as jentropy
from jpeg_tpu.entropy import device_codec as JDC
from jpeg_tpu.ops import pallas_kernels as PK
from jpeg_tpu.utils import parity as jparity

import jpeg_tpu_torch
from jpeg_tpu_torch import Configuration, QuantizationMethod
from jpeg_tpu_torch.entropy import device_codec as DC
from jpeg_tpu_torch.ops import kernels as K

torch.set_num_threads(2)


def _levels(n, L, seed, density=0.15, amp=2000):
    """Random sparse levels with the edge cases: a bare-EOB block, a lone
    last coefficient (the longest run), a dense block at +-16383."""
    rng = np.random.default_rng(seed)
    lv = np.where(rng.random((n, L)) < density,
                  rng.integers(-amp, amp + 1, (n, L)), 0).astype(np.int32)
    lv[0] = 0
    lv[1] = 0
    lv[1, L - 1] = -3
    lv[2] = rng.choice([-16383, 16383, -1, 1], L)
    return lv


def _jax_tables(lv):
    return [np.array(x) for x in JDC._unit_groups(jnp.asarray(lv))]


def _port_tables(lv):
    return DC._unit_groups(torch.from_numpy(lv))


@pytest.mark.parametrize("L", [16, 64, 144])
@pytest.mark.parametrize("density", [0.0, 0.15, 1.0])
def test_unit_groups_equal_jax(L, density):
    lv = _levels(40, L, seed=L, density=density)
    want = _jax_tables(lv)
    got = _port_tables(lv)
    for name, g, w in zip(("cbits", "vhi", "vlo", "blk_bytes"), got, want):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    # The block bytes are phase 1's (block_bytes_of) too.
    np.testing.assert_array_equal(
        got[3].numpy(), DC.block_bytes_of(torch.from_numpy(lv)).numpy())


def test_k9_plain_equals_pallas_interpret(monkeypatch):
    """Plain K9 vs the Pallas tables kernel in interpret mode on the same
    tables (ENC_TILE cut to 64 so the interpreted grid is small)."""
    monkeypatch.setenv("JPEG_TPU_PALLAS", "interpret")
    monkeypatch.setattr(PK, "ENC_TILE", 64)
    L = 16
    lv = _levels(70, L, seed=5, density=0.3, amp=16383)
    cb, vh, vl, bb = _jax_tables(lv)
    W = -(-int(bb.max()) // 4)
    want = np.asarray(PK.encode_stream_rows(jnp.asarray(cb), jnp.asarray(vh),
                                            jnp.asarray(vl), W,
                                            interpret=True))
    got = K.encode_stream_rows_tables(*(torch.from_numpy(x)
                                        for x in (cb, vh, vl)), W)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("L", [1, 16, 64])
def test_k9_plain_rows_equal_k1_rows(L):
    lv = _levels(300, L, seed=L + 1, density=0.2, amp=16383)
    t = torch.from_numpy(lv)
    cbits, vhi, vlo, bb = _port_tables(lv)
    W = -(-int(bb.max()) // 4)
    rows1, bb1 = K.encode_stream_rows(t, W)
    rows9 = K.encode_stream_rows_tables(cbits, vhi, vlo, W)
    assert torch.equal(rows9, rows1) and torch.equal(bb, bb1)
    # and the contiguous stream is the host C++ encoder's
    rows, bbt = DC.encode_rows(t, W, enc="tables")
    buf = DC.compact_rows(rows, bbt, int(bbt.to(torch.int64).sum()))
    assert buf.numpy().tobytes() == jentropy.encode_levels(lv)


def test_k9_truncates_a_long_block_and_the_check_raises():
    """A row narrower than a block keeps the block's first 4*W bytes (K1's
    contract), and encode_stream_sized's overflow check raises."""
    lv = _levels(20, 64, seed=9, density=0.5, amp=16383)
    t = torch.from_numpy(lv)
    cbits, vhi, vlo, bb = _port_tables(lv)
    W = -(-int(bb.max()) // 4)
    full = K.encode_stream_rows_tables(cbits, vhi, vlo, W)
    short = K.encode_stream_rows_tables(cbits, vhi, vlo, W - 2)
    assert torch.equal(short, full[:, :W - 2])
    assert torch.equal(short, K.encode_stream_rows(t, W - 2)[0])
    total = int(bb.to(torch.int64).sum())
    buf, _, bad = DC.encode_stream_sized(t, W - 2, total, enc="tables")
    assert bool(bad) and not buf.any()
    with pytest.raises(ValueError, match="overflow"):
        DC.check_sized_ok(bad)


def _image(h, w, seed=7):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    out = [np.clip(128 + 70 * np.sin(x / (17 + 6 * c)) * np.cos(y / (23 - 4 * c))
                   + 30 * np.sin((x + y) / (9 + 2 * c))
                   + 8 * rng.standard_normal((h, w)), 0, 255)
           for c in range(3)]
    return np.stack(out, axis=-1).astype(np.uint8)


@pytest.mark.parametrize("h,w,bs,d,q", [(64, 96, 2, 8, "qtable"),
                                        (45, 70, 3, 8, "none"),
                                        (40, 40, 2, 4, "none")])
def test_compress_tables_equals_lv_and_jax(h, w, bs, d, q):
    """The tables container is byte-equal to the lv container (f32), and in
    the f64 parity mode to jpeg_tpu's (x64) container."""
    img = _image(h, w)
    cfg = Configuration(width=w, height=h, block_size=bs, dct_size=d,
                        quantization=QuantizationMethod(q))
    jcfg = jpeg_tpu.Configuration(width=w, height=h, block_size=bs,
                                  dct_size=d,
                                  quantization=jpeg_tpu.QuantizationMethod(q))
    lv = jpeg_tpu_torch.compress_ycbcr(img, cfg, device="cpu")
    tables = jpeg_tpu_torch.compress_ycbcr(img, cfg, device="cpu",
                                           enc="tables")
    assert tables == lv
    f64 = jpeg_tpu_torch.compress_ycbcr(img, cfg, device="cpu",
                                        dtype=torch.float64, enc="tables")
    assert f64 == jpeg_tpu.compress_ycbcr(img, jcfg)
    # The f32 container is jpeg_tpu's f32 one except levels at ties.
    jblob = jpeg_tpu.compress_ycbcr(img, jcfg, dtype=np.float32)
    _, data = jcontainer.read_data(tables)
    _, jdata = jcontainer.read_data(jblob)
    L = d * d
    for b, (s, js) in enumerate(zip((data.y, data.cb, data.cr),
                                    (jdata.y, jdata.cb, jdata.cr))):
        _, ties = jparity.encode_reference_and_ties(jcfg, img[:, :, b])
        jparity.assert_tie_equal(jentropy.decode_levels(s, jcfg.num_blocks, L),
                                 jentropy.decode_levels(js, jcfg.num_blocks,
                                                        L), ties, f"band {b}")


def test_compress_many_and_jpeg_take_enc():
    img = _image(32, 48)
    cfg = Configuration(width=48, height=32,
                        quantization=QuantizationMethod("qtable"))
    imgs = [img, np.roll(img, 8, 1)]
    want = [jpeg_tpu_torch.compress_ycbcr(x, cfg, device="cpu") for x in imgs]
    assert jpeg_tpu_torch.compress_many(imgs, cfg, device="cpu",
                                        enc="tables") == want
    jp = jpeg_tpu_torch.Jpeg(cfg, device="cpu", enc="tables")
    assert jp.enc == "tables" and jp.compress(img) == want[0]


def test_tables_refuse_long_runs_and_unknown_enc():
    """L > 75: a 64-bit group cannot carry more than four chain bytes, so
    the tables path raises rather than run K1 instead; an unknown enc
    raises everywhere, before any work."""
    img = np.zeros((48, 48, 3), np.uint8)
    cfg24 = Configuration(width=48, height=48, block_size=2, dct_size=24)
    with pytest.raises(ValueError, match="cannot carry L=576"):
        jpeg_tpu_torch.compress_ycbcr(img, cfg24, device="cpu", enc="tables")
    with pytest.raises(ValueError, match="cannot carry L=576"):
        jpeg_tpu_torch.compress_many([img], cfg24, device="cpu", enc="tables")
    with pytest.raises(ValueError, match="cannot carry L=144"):
        DC.encode_rows(torch.zeros((2, 144), dtype=torch.int32), 4,
                       enc="tables")
    cfg = Configuration(width=48, height=48)
    for call in (
            lambda: jpeg_tpu_torch.compress_ycbcr(img, cfg, device="cpu",
                                                  enc="scatter"),
            lambda: jpeg_tpu_torch.compress_many([], cfg, device="cpu",
                                                 enc="LV"),
            lambda: DC.encode_rows(torch.zeros((2, 64), dtype=torch.int32),
                                   4, enc="")):
        with pytest.raises(ValueError, match="enc must be one of"):
            call()
    # L = 75 is the longest the tables take (a run of 74 = 4 chains + 14)
    lv = np.zeros((3, 75), np.int32)
    lv[0, 74] = 7
    lv[1, [0, 74]] = [1, -1]
    t = torch.from_numpy(lv)
    rows, bb = DC.encode_rows(t, 3, enc="tables")
    assert torch.equal(rows, DC.encode_rows(t, 3)[0])


def test_k9_wrapper_checks_inputs():
    z = torch.zeros((4, 65), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        K.encode_stream_rows_tables(z.to(torch.int64), z, z, 4)
    with pytest.raises(ValueError, match="differ"):
        K.encode_stream_rows_tables(z, z[:, :64].contiguous(), z, 4)
    with pytest.raises(ValueError, match="W must be"):
        K.encode_stream_rows_tables(z, z, z, 0)
    with pytest.raises(ValueError, match="different devices"):
        K.encode_stream_rows_tables(z, z.to("meta"), z, 4)
    before = K.launch_counts()["encode_stream_rows_tables"]
    assert torch.equal(K.encode_stream_rows_tables(z, z, z, 4),
                       torch.zeros((4, 4), dtype=torch.int32))
    assert K.launch_counts()["encode_stream_rows_tables"] == before
