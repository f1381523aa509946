"""Sharding at padded height: every share takes the whole image's branch.

A share of a plane's block rows that stops above a padded bottom edge is
itself divisible, so a ``BandEncoder`` / ``BandDecoder`` built from the
share's own geometry would run ``separable`` / ``combined`` where the
serial call of the whole padded image runs ``sep_pad`` / ``blocks`` (K5) /
``chain``; at f32 round ties the two branches round differently.  The
shares take the whole image's branch (``_image=``), so the sharded bytes
and planes equal the port's serial ones in f32, and in f64 they equal
``jpeg_tpu.parallel``'s.

The reproducer is a 64 x 40 plane of ``default_rng(1)`` integers, bs 2,
d 8, quantization ``"none"``, on a 1 x 2 mesh (block rows [0, 2) and
[2, 3)).  The fuzz draws padded heights with widths divisible by
``dct_size * block_size``, 2-4 shares, DCT and DFT, ``"none"`` and
``"divide"``, and runs every sharded entry point in f32.
"""
import numpy as np
import pytest
import torch

import jpeg_tpu
from jpeg_tpu import parallel as jparallel

import jpeg_tpu_torch
from jpeg_tpu_torch import Configuration, QuantizationMethod, parallel
from jpeg_tpu_torch.ops.band import BandDecoder, BandEncoder
from jpeg_tpu_torch.parallel import multihost, sharded

torch.set_num_threads(2)
CPU = torch.device("cpu")
F64 = torch.float64
FUZZ_DRAWS = 60
# Non-integer divisors decode by truncation: the ``chain`` branch at
# padded height (``combined`` on a divisible share).
DIVISORS = (3, 40, 2.5, 0.7, 3.3)

pytestmark = pytest.mark.filterwarnings(
    "ignore:dimension of size:UserWarning")


def _mesh(n):
    return parallel.make_mesh(devices=[CPU] * n, data=1, band=n)


def _configs(w, h, bs, d, transform, qname, divisor=None):
    q = {"divisor": divisor} if qname == "divide" else {}
    kw = dict(width=w, height=h, block_size=bs, dct_size=d,
              transform=transform)
    return (Configuration(quantization=QuantizationMethod(qname, **q), **kw),
            jpeg_tpu.Configuration(
                quantization=jpeg_tpu.QuantizationMethod(qname, **q), **kw))


def test_reproducer_sharded_bytes_equal_serial():
    plane = np.random.default_rng(1).integers(0, 256, (40, 64))
    cfg, _ = _configs(64, 40, 2, 8, "DCT", "none")
    mesh = parallel.make_mesh(2, data=1, devices=[CPU] * 2)
    assert [(s.r0, s.r1) for s in sharded.row_shares(mesh, cfg)] == \
        [(0, 2), (2, 3)]
    got = sharded.compress_plane(plane, cfg, mesh, dtype="float32")
    assert got == jpeg_tpu_torch.compress_band(plane, cfg, "float32",
                                               device="cpu")


@pytest.mark.parametrize("transform,qname,branches", [
    ("DCT", "none", ("sep_pad", "kernel")),
    ("DFT", "none", ("blocks", "kernel")),
    ("DCT", "divide", ("sep_pad", "chain")),
])
def test_share_takes_whole_image_branch(transform, qname, branches):
    """A share above the padded edge (divisible on its own) runs the whole
    image's branches; without ``_image`` it would run its own."""
    cfg, _ = _configs(64, 40, 2, 8, transform, qname, 2.5)
    share_cfg, _, _ = sharded._row_config(cfg, 0, 2)
    own = (BandEncoder(share_cfg).branch, BandDecoder(share_cfg).branch)
    assert own != branches
    assert (BandEncoder(share_cfg, _image=cfg).branch,
            BandDecoder(share_cfg, _image=cfg).branch) == branches
    assert (BandEncoder(cfg).branch, BandDecoder(cfg).branch) == branches


def test_distributed_single_process_takes_the_whole_plane():
    """One process: the whole plane, whatever the device count divides,
    through the sharded encode; another shape raises as before."""
    plane = np.random.default_rng(1).integers(0, 256, (40, 64))
    cfg, _ = _configs(64, 40, 2, 8, "DCT", "none")
    mesh = _mesh(3)
    assert multihost.host_rows(cfg, 1, 0, mesh) == (0, 3, 0, 40)
    assert multihost.compress_plane_distributed(plane, cfg, mesh) == \
        jpeg_tpu_torch.compress_band(plane, cfg, device="cpu")
    with pytest.raises(ValueError, match="expected a plane of shape"):
        multihost.compress_plane_distributed(plane[:20], cfg, mesh)


def _draw(k):
    """Draw k of the fuzz: a padded height whose block rows divide by the
    share count n (so ``compress_batch``'s band axis splits too), a width
    divisible by D, a tie-dense random plane."""
    rng = np.random.default_rng(9100 + k)
    n = int(rng.integers(2, 5))
    d = int(rng.choice([2, 3, 4, 8]))
    bs = int(rng.integers(1, 4))
    D = d * bs
    rows = n * int(rng.integers(1, 3))
    h = D * (rows - 1) + int(rng.integers(1, D))
    w = D * int(rng.integers(1, 4))
    transform = str(rng.choice(["DCT", "DFT"]))
    qname = str(rng.choice(["none", "divide"]))
    div = DIVISORS[int(rng.integers(len(DIVISORS)))]
    cfg, jcfg = _configs(w, h, bs, d, transform, qname, div)
    images = rng.integers(0, 256, (2, h, w, 3)).astype(np.uint8)
    return n, cfg, jcfg, images


@pytest.mark.parametrize("k", range(FUZZ_DRAWS))
def test_fuzz_padded_height_sharded_equals_serial(k):
    n, cfg, jcfg, images = _draw(k)
    assert cfg.blocks_high % n == 0 and cfg.height % (
        cfg.dct_size * cfg.block_size) != 0
    mesh = _mesh(n)
    assert len(sharded.row_shares(mesh, cfg)) == n
    plane = images[0, :, :, 0].astype(np.int32)
    serial = jpeg_tpu_torch.compress_band(plane, cfg, device="cpu")
    assert parallel.compress_plane(plane, cfg, mesh) == serial
    assert parallel.compress_plane_device_entropy(plane, cfg, mesh) == serial
    want = jpeg_tpu_torch.decompress_band(serial, cfg, device="cpu")
    np.testing.assert_array_equal(
        parallel.decompress_plane(serial, cfg, mesh), want)

    blobs = parallel.compress_batch(images, cfg, mesh, device_entropy=k % 2)
    assert len(sharded.batch_shares(mesh, cfg, len(images))) == n
    assert blobs == [jpeg_tpu_torch.compress_ycbcr(im, cfg, device="cpu")
                     for im in images]
    rec = parallel.decompress_batch(blobs, mesh, device_entropy=k % 2)
    for r, b in zip(rec, blobs):
        np.testing.assert_array_equal(
            r, jpeg_tpu_torch.decompress_to_ycbcr(b, device="cpu"))

    # f64: the port's sharded bytes and planes are jpeg_tpu's.
    got64 = parallel.compress_plane(plane, cfg, mesh, dtype=F64)
    jmesh = jparallel.make_mesh(n)
    assert got64 == jparallel.compress_plane(plane, jcfg, jmesh,
                                             dtype=np.float64)
    np.testing.assert_array_equal(
        parallel.decompress_plane(got64, cfg, mesh, dtype=F64),
        jparallel.decompress_plane(got64, jcfg, jmesh, dtype=np.float64))
    if k % 3 == 0:
        blobs64 = parallel.compress_batch(images, cfg, mesh, dtype=F64)
        assert blobs64 == jparallel.compress_batch(images, jcfg, jmesh,
                                                   dtype=np.float64)
        np.testing.assert_array_equal(
            parallel.decompress_batch(blobs64, mesh, dtype=F64),
            jparallel.decompress_batch(blobs64, jmesh, dtype=np.float64))
