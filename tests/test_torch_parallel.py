"""jpeg_tpu_torch.parallel vs the port's serial path and jpeg_tpu.parallel.

The port's sharded bytes equal its own serial bytes (f32 and f64), and in
f64 they equal ``jpeg_tpu.parallel``'s on its 8-device virtual CPU mesh
(``tests/conftest.py``); f32 planes are held to the tie contract of
``utils/parity.py`` against ``jpeg_tpu``.  The port's mesh here is eight
entries of ``torch.device("cpu")``: every share runs the kernels' plain
PyTorch versions.  Mirrors ``tests/test_parallel.py`` case by case (but
the two ``__graft_entry__`` tests), plus the sharding helpers' index maps
against JAX's ``devices_indices_map``, the statistics against
``jpeg_tpu.parallel.stats``, and the seams: uneven rows, more devices than
block rows, padded geometry.
"""
import warnings

import numpy as np
import pytest
import torch

import jpeg_tpu
from jpeg_tpu import parallel as jparallel
from jpeg_tpu.ops.band import encode_band_levels
from jpeg_tpu.utils import parity as jparity

import jpeg_tpu_torch
from jpeg_tpu_torch import (BadRleCodeError, Configuration,
                            QuantizationMethod, entropy, parallel)
from jpeg_tpu_torch.ops.band import BandEncoder
from jpeg_tpu_torch.parallel import multihost, sharded

torch.set_num_threads(2)
CPU = torch.device("cpu")
F64 = torch.float64

pytestmark = pytest.mark.filterwarnings(
    "ignore:dimension of size:UserWarning")


def _mesh(**kw):
    return parallel.make_mesh(devices=[CPU] * 8, **kw)


def _cfg(w, h, qname="qtable", **kw):
    params = {"divisor": kw.pop("divisor")} if "divisor" in kw else {}
    return (Configuration(width=w, height=h, quantization=QuantizationMethod(
                qname, **params), **kw),
            jpeg_tpu.Configuration(width=w, height=h,
                                   quantization=jpeg_tpu.QuantizationMethod(
                                       qname, **params), **kw))


def _serial(plane, cfg, dtype=None):
    return jpeg_tpu_torch.compress_band(plane, cfg, dtype, device="cpu")


def _plane(h, w, seed=42):
    return np.random.default_rng(seed).integers(0, 256, (h, w),
                                                dtype=np.int32)


def _smooth(h, w):
    y, x = np.mgrid[0:h, 0:w]
    return np.clip(128 + 80 * np.sin(x / 37.0) * np.cos(y / 23.0),
                   0, 255).astype(np.int32)


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,max_band", [(8, 8), (4, 8), (2, 8), (1, 8),
                                        (6, 8), (12, 4), (7, 8), (16, 2)])
def test_factorize(n, max_band):
    assert parallel.factorize(n, max_band) == \
        jparallel.factorize(n, max_band)


def test_factorize_rejects_zero():
    for f in (parallel.factorize, jparallel.factorize):
        with pytest.raises(ValueError, match="at least one device"):
            f(0)


def test_make_mesh_axes():
    mesh = _mesh()
    assert mesh.axis_names == ("data", "band")
    assert mesh.devices.size == 8 and mesh.devices.shape == (1, 8)
    assert all(d == CPU for d in mesh.devices.flat)
    assert _mesh(data=2, band=4).devices.shape == (2, 4)


@pytest.mark.parametrize("kw", [{"data": 4}, {"band": 2}, {"data": 2,
                                                          "band": 4},
                                {"n_devices": 4}, {"n_devices": 6},
                                {"n_devices": 8, "data": 3},
                                {"band": 3}, {"n_devices": 9},
                                {"data": 2, "band": 2}])
def test_make_mesh_arguments_as_jax(kw):
    """Every argument rule and error of jpeg_tpu's make_mesh, on the same
    eight devices."""
    try:
        want = jparallel.make_mesh(**kw).devices.shape
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            _mesh(**kw)
        assert str(got.value) == str(e)
        return
    assert _mesh(**kw).devices.shape == want


def test_make_mesh_single_axis_honored():
    assert _mesh(data=4).devices.shape == (4, 2)
    assert _mesh(band=2).devices.shape == (4, 2)
    with pytest.raises(ValueError):
        _mesh(n_devices=8, data=3)


def test_make_mesh_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default mesh is its devices")
    with pytest.raises(RuntimeError, match="cuda"):
        parallel.make_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        parallel.make_mesh(devices=["cuda"])


def _jax_map(sharding, jmesh, shape):
    """JAX's devices_indices_map keyed by mesh position."""
    pos = {d: tuple(int(i) for i in np.argwhere(jmesh.devices == d)[0])
           for d in jmesh.devices.flat}
    return {pos[d]: idx
            for d, idx in sharding.devices_indices_map(shape).items()}


_MAP_CASES = [(h, s) for h in ("batch_sharding", "levels_sharding")
              for s in ((8, 16, 4), (3, 16, 64), (6, 5, 7))] + \
    [("plane_sharding", s) for s in ((16, 8), (12, 9), (6, 5))] + \
    [("replicated", s) for s in ((3, 16, 64), (12, 9))]


@pytest.mark.parametrize("helper,shape", _MAP_CASES)
@pytest.mark.parametrize("axes", [(1, 8), (2, 4), (4, 2), (8, 1)])
def test_index_maps_match_jax_devices_indices_map(helper, shape, axes):
    jmesh = jparallel.make_mesh(data=axes[0], band=axes[1])
    tmesh = _mesh(data=axes[0], band=axes[1])
    if helper == "replicated":
        want = _jax_map(jparallel.replicated(jmesh), jmesh, shape)
        got = parallel.replicated(tmesh, shape)
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = _jax_map(getattr(jparallel, helper)(jmesh, shape),
                            jmesh, shape)
        got = getattr(parallel, helper)(tmesh, shape)
    assert got == want


def test_fit_spec_matches_jax_and_warns():
    from jax.sharding import PartitionSpec as P
    from jpeg_tpu.parallel import mesh as jmesh_lib
    from jpeg_tpu_torch.parallel import mesh as tmesh_lib
    jm = jparallel.make_mesh(data=2, band=4)
    tm = _mesh(data=2, band=4)
    for shape in [(4, 8, 3), (3, 8, 3), (4, 6, 3), (1, 1, 1)]:
        spec = ("data", "band", None)
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            want = tuple(jmesh_lib.fit_spec(shape, jm, P(*spec)))
        with warnings.catch_warnings(record=True) as tw:
            warnings.simplefilter("always")
            got = tmesh_lib.fit_spec(shape, tm, spec)
        assert got == want + (None,) * (len(got) - len(want))
        assert [str(w.message) for w in tw] == [str(w.message) for w in jw]


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------

def test_block_bytes_match_entropy_coder():
    tcfg, jcfg = _cfg(64, 64, "none", block_size=1)
    band = _plane(64, 64)
    levels = BandEncoder(tcfg)(torch.from_numpy(band)[None])[0]
    got = parallel.block_bytes(levels).numpy()
    for i in range(levels.shape[0]):
        assert got[i] == len(entropy.encode_levels(levels[i:i + 1].numpy()))
    import jax.numpy as jnp
    np.testing.assert_array_equal(
        got, np.asarray(jparallel.block_bytes(jnp.asarray(levels.numpy()))))


def test_block_bytes_edge_cases():
    # all-zero block = 1 EOB byte; long zero runs; negative amps; amp 16383
    rows = np.zeros((4, 64), dtype=np.int32)
    rows[1, 0] = -5
    rows[2, 63] = 1          # 63 zeros: 4 chains + code
    rows[3, 0] = 16383       # size 15
    got = parallel.block_bytes(torch.from_numpy(rows)).numpy()
    for i in range(4):
        assert got[i] == len(entropy.encode_levels(rows[i:i + 1])), i


@pytest.mark.parametrize("L,shape", [(64, (3, 50)), (9, (7,)), (576, (2, 3))])
def test_stats_match_jax(L, shape):
    import jax.numpy as jnp
    rng = np.random.default_rng(L)
    lv = np.where(rng.random(shape + (L,)) < 0.3,
                  rng.integers(-3000, 3000, shape + (L,)), 0).astype(np.int32)
    t, j = torch.from_numpy(lv), jnp.asarray(lv)
    np.testing.assert_array_equal(parallel.block_bits(t).numpy(),
                                  np.asarray(jparallel.block_bits(j)))
    np.testing.assert_array_equal(parallel.block_bytes(t).numpy(),
                                  np.asarray(jparallel.block_bytes(j)))
    assert int(parallel.total_bytes(t)) == int(jparallel.total_bytes(j))


# ---------------------------------------------------------------------------
# shares
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axes", [(1, 8), (2, 4), (8, 1)])
@pytest.mark.parametrize("n_img,hw", [(4, (128, 32)), (3, (24, 32)),
                                      (8, (40, 56))])
def test_batch_shares_partition_the_grid(axes, n_img, hw):
    """Every (image, block row) is in exactly one share."""
    tcfg, _ = _cfg(hw[1], hw[0], block_size=2)
    shares = sharded.batch_shares(_mesh(data=axes[0], band=axes[1]), tcfg,
                                  n_img)
    seen = np.zeros((n_img, tcfg.blocks_high), int)
    for s in shares:
        seen[s.i0:s.i1, s.r0:s.r1] += 1
    assert (seen == 1).all()


def test_row_shares_drop_empty_parts():
    tcfg, _ = _cfg(24, 5 * 2 * 8, block_size=2)      # 5 block rows
    shares = sharded.row_shares(_mesh(), tcfg)
    assert [(s.r0, s.r1) for s in shares] == [(k, k + 1) for k in range(5)]


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axes", [(1, 8), (2, 4)])
def test_batch_encode_matches_single_device(axes):
    tcfg, jcfg = _cfg(48, 128, block_size=2)
    mesh = _mesh(data=axes[0], band=axes[1])
    bands = np.random.default_rng(42).integers(0, 256, (4, 128, 48),
                                               dtype=np.int32)
    levels, nbytes = parallel.encode_batch_levels(bands, tcfg, mesh)
    for i in range(4):
        ref = BandEncoder(tcfg)(torch.from_numpy(bands[i])[None])[0]
        np.testing.assert_array_equal(levels[i], ref.numpy())
    expect = sum(len(entropy.encode_levels(levels[i])) for i in range(4))
    assert nbytes == expect
    lv64, n64 = parallel.encode_batch_levels(bands, tcfg, mesh, dtype=F64)
    jlv, jn = jparallel.encode_batch_levels(
        bands, jcfg, jparallel.make_mesh(8), dtype=np.float64)
    np.testing.assert_array_equal(lv64, jlv)
    assert n64 == jn


@pytest.mark.parametrize("height", [8 * 2 * 8, 5 * 2 * 8, 100])
def test_rowband_stitch_bit_identical(height):
    """8 block rows (one a device), 5 (three devices without a share), and
    100 rows (a padded last block row)."""
    tcfg, jcfg = _cfg(40, height, block_size=2)
    mesh = _mesh()
    plane = _plane(height, 40)
    assert parallel.compress_plane(plane, tcfg, mesh) == _serial(plane, tcfg)
    got64 = parallel.compress_plane(plane, tcfg, mesh, dtype=F64)
    assert got64 == _serial(plane, tcfg, F64)
    assert got64 == jparallel.compress_plane(plane, jcfg,
                                             jparallel.make_mesh(8),
                                             dtype=np.float64)


def test_rowband_stitch_uneven_rows():
    # 5 block-rows across 8 shards: some shards empty, bounds clamp.
    tcfg, jcfg = _cfg(24, 5 * 2 * 8, block_size=2)
    plane = _plane(tcfg.height, tcfg.width)
    got = parallel.compress_plane(plane, tcfg, _mesh())
    assert got == _serial(plane, tcfg)
    # f32 against jpeg_tpu's f32 levels: equal except +-1 at ties.
    _, ties = jparity.encode_reference_and_ties(jcfg, plane)
    want = np.asarray(encode_band_levels(plane, jcfg, dtype=np.float32))
    jparity.assert_tie_equal(entropy.decode_levels(got, jcfg.num_blocks, 64),
                             want, ties)


def test_device_entropy_sharded_stitch():
    tcfg, jcfg = _cfg(40, 8 * 2 * 8, block_size=2)
    plane = _plane(tcfg.height, tcfg.width)
    got = parallel.compress_plane_device_entropy(plane, tcfg, _mesh())
    assert got == _serial(plane, tcfg)
    got64 = parallel.compress_plane_device_entropy(plane, tcfg, _mesh(),
                                                   dtype=F64)
    assert got64 == jparallel.compress_plane_device_entropy(
        plane, jcfg, jparallel.make_mesh(8), dtype=np.float64)


def test_device_entropy_sharded_stitch_uneven():
    # 15 blocks over 8 devices: 5 block rows of 3, three devices idle.
    tcfg, _ = _cfg(24, 5 * 2 * 8, block_size=2)
    plane = _plane(tcfg.height, tcfg.width)
    assert parallel.compress_plane_device_entropy(plane, tcfg, _mesh()) == \
        _serial(plane, tcfg)


@pytest.mark.parametrize("label,h,w,bs,d,transform,qname,div", [
    ("bs5", 75, 52, 5, 8, "DCT", "qtable", None),
    ("d24", 200, 100, 4, 24, "DCT", "divide", 1000),
    ("dft-ragged", 70, 50, 3, 8, "DFT", "none", None),
    ("tiny", 9, 5, 3, 2, "DCT", "none", None),
])
def test_padded_geometry_seams(label, h, w, bs, d, transform, qname, div):
    """Padded geometry: only the last share reaches the padded edge, and
    encode and decode equal the serial path's on every seam."""
    kw = {"divisor": div} if div else {}
    tcfg = Configuration(width=w, height=h, block_size=bs, dct_size=d,
                         transform=transform,
                         quantization=QuantizationMethod(qname, **kw))
    mesh = _mesh()
    plane = _smooth(h, w)
    serial = _serial(plane, tcfg)
    assert len(sharded.row_shares(mesh, tcfg)) > 1
    assert parallel.compress_plane(plane, tcfg, mesh) == serial
    assert parallel.compress_plane_device_entropy(plane, tcfg, mesh) == serial
    want = jpeg_tpu_torch.decompress_band(serial, tcfg, device="cpu")
    for de in (True, False):
        np.testing.assert_array_equal(
            parallel.decompress_plane(serial, tcfg, mesh, device_entropy=de),
            want)


def test_compress_batch_roundtrip_matches_api():
    tcfg, _ = _cfg(32, 24, block_size=2)
    mesh = _mesh()
    imgs = np.random.default_rng(42).integers(0, 256, (3, 24, 32, 3),
                                              dtype=np.uint8)
    blobs = parallel.compress_batch(imgs, tcfg, mesh)
    for i in range(3):
        assert blobs[i] == jpeg_tpu_torch.compress_ycbcr(imgs[i], tcfg,
                                                         device="cpu")
    recon = parallel.decompress_batch(blobs, mesh)
    assert recon.shape == imgs.shape and recon.dtype == np.uint8
    for i in range(3):
        np.testing.assert_array_equal(
            recon[i], jpeg_tpu_torch.decompress_to_ycbcr(blobs[i],
                                                         device="cpu"))


@pytest.mark.parametrize("axes", [(1, 8), (2, 4), (4, 2)])
def test_compress_batch_f64_matches_jax(axes):
    """Data and band shares: f64 containers and planes equal jpeg_tpu's."""
    tcfg, jcfg = _cfg(32, 64, block_size=2)
    imgs = np.random.default_rng(5).integers(0, 256, (4, 64, 32, 3),
                                             dtype=np.uint8)
    mesh = _mesh(data=axes[0], band=axes[1])
    jmesh = jparallel.make_mesh(data=axes[0], band=axes[1])
    blobs = parallel.compress_batch(imgs, tcfg, mesh, dtype=F64)
    assert blobs == jparallel.compress_batch(imgs, jcfg, jmesh,
                                             dtype=np.float64)
    np.testing.assert_array_equal(
        parallel.decompress_batch(blobs, mesh, dtype=F64),
        jparallel.decompress_batch(blobs, jmesh, dtype=np.float64))


def test_compress_batch_rejects_bad_shape():
    tcfg, _ = _cfg(8, 8)
    with pytest.raises(ValueError):
        parallel.compress_batch(np.zeros((2, 8, 8), np.uint8), tcfg, _mesh())


def test_fullhd_rowband_pipeline():
    # 1080p plane through the row-band + stitch path (f32).
    tcfg = Configuration(width=1920, height=1080, block_size=2, dct_size=8,
                         quantization=QuantizationMethod("qtable"))
    plane = _smooth(1080, 1920)
    assert parallel.compress_plane(plane, tcfg, _mesh()) == \
        _serial(plane, tcfg)


def test_compress_batch_device_entropy_matches_host():
    tcfg, _ = _cfg(32, 24, block_size=2)
    mesh = _mesh()
    imgs = np.random.default_rng(42).integers(0, 256, (3, 24, 32, 3),
                                              dtype=np.uint8)
    host_blobs = parallel.compress_batch(imgs, tcfg, mesh,
                                         device_entropy=False)
    dev_blobs = parallel.compress_batch(imgs, tcfg, mesh, device_entropy=True)
    assert dev_blobs == host_blobs
    assert parallel.compress_batch(imgs, tcfg, mesh) == host_blobs


def test_4k_batch_rowband_stitch():
    # BASELINE.json config 5: 4K image set through the sharded mesh path.
    tcfg = Configuration(width=3840, height=2160, block_size=2, dct_size=8,
                         quantization=QuantizationMethod("qtable"))
    mesh = _mesh()
    y, x = np.mgrid[0:2160, 0:3840]
    plane = np.clip(128 + 80 * np.sin(x / 41.0) * np.cos(y / 29.0),
                    0, 255).astype(np.int32)
    assert parallel.compress_plane(plane, tcfg, mesh) == _serial(plane, tcfg)
    imgs = np.repeat(plane[None, :, :, None], 3, axis=3).astype(np.uint8)[:1]
    blobs = parallel.compress_batch(imgs, tcfg, mesh)
    assert blobs[0] == jpeg_tpu_torch.compress_ycbcr(imgs[0], tcfg,
                                                     device="cpu")


def test_device_entropy_plane_rejects_overrange():
    tcfg, _ = _cfg(48, 48, "none", block_size=1, dct_size=24)
    plane = np.full((48, 48), 200, dtype=np.int32)
    with pytest.raises(BadRleCodeError):
        parallel.compress_plane_device_entropy(plane, tcfg, _mesh())
    with pytest.raises(BadRleCodeError):
        parallel.compress_batch(np.full((1, 48, 48, 3), 200, np.uint8), tcfg,
                                _mesh(), device_entropy=True)


def test_multihost_indivisible_height():
    # Single process: height 100 is no multiple of 8 devices.
    tcfg, _ = _cfg(32, 100, block_size=2)
    plane = _plane(100, 32)
    got = multihost.compress_plane_distributed(plane, tcfg, _mesh())
    assert got == _serial(plane, tcfg)


def test_decompress_batch_device_entropy_matches_host():
    tcfg, jcfg = _cfg(32, 24, block_size=2)
    mesh = _mesh()
    imgs = np.random.default_rng(42).integers(0, 256, (3, 24, 32, 3),
                                              dtype=np.uint8)
    blobs = parallel.compress_batch(imgs, tcfg, mesh, device_entropy=False)
    host = parallel.decompress_batch(blobs, mesh, device_entropy=False)
    dev = parallel.decompress_batch(blobs, mesh, device_entropy=True)
    np.testing.assert_array_equal(dev, host)
    want = jparallel.decompress_batch(blobs, jparallel.make_mesh(8),
                                      dtype=np.float32)
    for i, blob in enumerate(blobs):
        _, data = jpeg_tpu.container.read_data(blob)
        for b, s in enumerate((data.y, data.cb, data.cr)):
            lv = jpeg_tpu.entropy.decode_levels(s, jcfg.num_blocks, 64)
            _, ties = jparity.decode_reference_and_ties(jcfg, lv)
            jparity.assert_tie_equal(dev[i, :, :, b], want[i, :, :, b], ties)


@pytest.mark.parametrize("trial", range(8))
def test_fuzz_sharded_equals_serial(trial):
    """Random geometry through both sharded encode paths == serial bytes
    (f32), and == jpeg_tpu's sharded bytes in f64."""
    rng = np.random.default_rng(4200 + trial)
    w = int(rng.integers(1, 70))
    h = int(rng.integers(1, 70))
    bs = int(rng.integers(1, 6))
    d = int(rng.choice([2, 3, 4, 8]))
    qn = str(rng.choice(["none", "divide", "qtable"]))
    if qn == "qtable":
        d = 8
    kw = {"divisor": 40} if qn == "divide" else {}
    tcfg, jcfg = _cfg(w, h, qn, block_size=bs, dct_size=d, **kw)
    mesh = _mesh()
    plane = rng.integers(0, 256, (h, w)).astype(np.int64)
    serial = _serial(plane, tcfg)
    assert parallel.compress_plane(plane, tcfg, mesh) == serial
    assert parallel.compress_plane_device_entropy(plane, tcfg, mesh) == serial
    assert parallel.compress_plane(plane, tcfg, mesh, dtype=F64) == \
        jparallel.compress_plane(plane, jcfg, jparallel.make_mesh(8),
                                 dtype=np.float64)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def test_decompress_plane_matches_decompress_band():
    tcfg, jcfg = _cfg(96, 8 * 2 * 8, block_size=2)
    mesh = _mesh()
    plane = _plane(tcfg.height, tcfg.width)
    stream = _serial(plane, tcfg)
    want = jpeg_tpu_torch.decompress_band(stream, tcfg, device="cpu")
    dev = parallel.decompress_plane(stream, tcfg, mesh, device_entropy=True)
    host = parallel.decompress_plane(stream, tcfg, mesh, device_entropy=False)
    np.testing.assert_array_equal(dev, want)
    np.testing.assert_array_equal(host, want)
    assert dev.dtype == np.int32
    np.testing.assert_array_equal(
        parallel.decompress_plane(stream, tcfg, mesh, dtype=F64),
        jparallel.decompress_plane(stream, jcfg, jparallel.make_mesh(8),
                                   dtype=np.float64, device_entropy=True))


def test_decompress_plane_uneven_blocks():
    tcfg, _ = _cfg(24, 5 * 2 * 8, block_size=2)
    plane = _plane(tcfg.height, tcfg.width)
    stream = _serial(plane, tcfg)
    want = jpeg_tpu_torch.decompress_band(stream, tcfg, device="cpu")
    got = parallel.decompress_plane(stream, tcfg, _mesh(),
                                    device_entropy=True)
    np.testing.assert_array_equal(got, want)


def test_decompress_plane_fullhd():
    # sharded device-entropy encode, then sharded device-parse decode.
    tcfg = Configuration(width=1920, height=1080, block_size=2, dct_size=8,
                         quantization=QuantizationMethod("qtable"))
    mesh = _mesh()
    plane = _smooth(1080, 1920)
    stream = parallel.compress_plane_device_entropy(plane, tcfg, mesh)
    want = jpeg_tpu_torch.decompress_band(stream, tcfg, device="cpu")
    got = parallel.decompress_plane(stream, tcfg, mesh, device_entropy=True)
    np.testing.assert_array_equal(got, want)


def _band_streams(nb, L, n_bands, seed):
    rng = np.random.default_rng(seed)
    streams, scans = [], []
    for _ in range(n_bands):
        lv = np.zeros((nb, L), np.int32)
        m = rng.random(lv.shape) < 0.4
        lv[m] = rng.integers(-2000, 2000, int(m.sum()))
        s = entropy.encode_levels(lv)
        streams.append(s)
        scans.append(entropy.scan_offsets(s, nb, L, scan="host"))
    return streams, scans


def test_shard_stream_slices_addressable_bytes():
    """Each share's slice holds only its own blocks' bytes (no device holds
    the whole batch stream), and slice + local starts give every block's
    bytes exactly."""
    nb, L = 64, 64
    streams, scans = _band_streams(nb, L, 6, 11)
    total = sum(len(s) for s in streams)
    # 8 shares: 6 bands x 64 blocks split as 8 rows of 8 blocks, 4 shares
    # of rows [0, 4) and [4, 8) over 3 bands each
    ranges = [[(g, r * 32, (r + 1) * 32) for g in range(3 * k, 3 * k + 3)]
              for k in range(2) for r in range(2)]
    slices = sharded._shard_stream_slices(streams, scans, ranges)
    assert sum(len(b) for b, _ in slices) == total
    for (buf, st), rng in zip(slices, ranges):
        assert len(buf) * 3 <= total
        assert st.dtype == np.int64 and len(st) == sum(b - a for _, a, b in
                                                       rng)
        k = 0
        for g, a, b in rng:
            ends = np.append(scans[g][1:], len(streams[g]))
            for j in range(a, b):
                blk = streams[g][scans[g][j]:ends[j]]
                assert buf[st[k]:st[k] + len(blk)].tobytes() == blk
                k += 1


def test_shard_stream_slices_uneven_blocks():
    """Shares of unequal block counts (5 blocks a band, 3 bands, shares of
    2 / 2 / 1 blocks of each): the slices still reproduce every block, and
    the last block of a band ends at its stream's end."""
    nb, L = 5, 16
    streams, scans = [], []
    for i in range(3):
        lv = np.zeros((nb, L), np.int32)
        lv[:, 0] = i + 1
        s = entropy.encode_levels(lv)
        streams.append(s)
        scans.append(entropy.scan_offsets(s, nb, L, scan="host"))
    ranges = [[(g, a, b) for g in range(3)] for a, b in
              ((0, 2), (2, 4), (4, 5))]
    slices = sharded._shard_stream_slices(streams, scans, ranges)
    assert [len(st) for _, st in slices] == [6, 6, 3]
    buf, st = slices[2]
    assert buf.tobytes() == b"".join(s[scans[g][4]:] for g, s in
                                     enumerate(streams))
    assert list(st) == [0, len(streams[0]) - scans[0][4],
                        len(streams[0]) - scans[0][4]
                        + len(streams[1]) - scans[1][4]]


def test_decompress_plane_distributed_single_process():
    """Single process: the distributed decode dual degenerates to the
    sharded plane decode, equal to the serial decoder."""
    tcfg, _ = _cfg(64, 48, block_size=2)
    plane = _plane(48, 64)
    stream = _serial(plane, tcfg)
    got = multihost.decompress_plane_distributed(stream, tcfg, _mesh())
    np.testing.assert_array_equal(
        got, jpeg_tpu_torch.decompress_band(stream, tcfg, device="cpu"))


@pytest.mark.parametrize("nproc,height", [(2, 128), (4, 128), (3, 100),
                                          (8, 48)])
def test_host_rows_split_on_block_rows(nproc, height):
    """The JAX package's split (one device a process): ``height // nproc``
    image rows each in rank order where the height divides, else the
    whole plane each; the block rows split on the processes holding their
    first image rows."""
    tcfg, _ = _cfg(32, height, block_size=2)
    D = 16
    one = parallel.make_mesh(devices=[CPU])
    rows = [multihost.host_rows(tcfg, nproc, p, one) for p in range(nproc)]
    if height % nproc:
        assert rows == [(0, tcfg.blocks_high, 0, height)] * nproc
        return
    assert rows[0][2] == 0 and rows[-1][3] == height
    assert rows[0][0] == 0 and rows[-1][1] == tcfg.blocks_high
    for (_, r1, _, y1), (r0, _, y0, _) in zip(rows, rows[1:]):
        assert r1 == r0 and y1 == y0
    for r0, r1, y0, y1 in rows:
        assert y1 - y0 == height // nproc
        assert all(y0 <= r * D < y1 for r in range(r0, r1))
