"""Multi-process runs of jpeg_tpu_torch.parallel.multihost over gloo.

Mirrors ``tests/test_multihost_2proc.py`` (2 and 4 processes) and
``tests/test_batch_cli.py::test_batch_cli_distributed_two_process``: real
processes join a gloo process group over localhost, each with four
entries of ``torch.device("cpu")`` as its mesh, and

* ``compress_plane_distributed`` takes each process's rows as the JAX
  package splits them (``height / devices`` rows a device of the global
  mesh: 24 rows each at H = 48 on two processes of four devices), and
  gives every process the stitched stream, byte-equal to the serial
  encoder's (f32; in f64 also to ``jpeg_tpu``'s), on planes whose block
  rows straddle the processes' rows, at a padded height in f32 (ties:
  quantization ``"none"``), and over more processes than block rows; a
  height that does not divide by the global device count raises
  ``ValueError``, as in the JAX package;
* ``decompress_plane_distributed`` returns each process the rows JAX's
  rule gives it (the whole plane where the height does not divide),
  equal to the serial decoder's;
* ``compress_batch_distributed``'s manifest is identical on every process
  and its blobs equal per-image ``compress_ycbcr``;
* ``python -m jpeg_tpu_torch batch --distributed`` writes, over both
  processes, the serial run's files byte for byte.

Every process has its own timeout, a free port from the OS, and is killed
when any of them fails.  This file is also the child program:
``python test_torch_multihost.py <port> <nproc> <pid> <outdir>``.
"""
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CHILD_TIMEOUT_S = 240
# (name, height, width, quantization, devices a process): block rows that
# split evenly over 2 and 4 processes; H = 48 (24 image rows a process on
# two processes: block row 1 straddles them); 2 block rows (4 processes
# leave two without one); a padded height with ties (the 64 x 40
# sharding reproducer, 2 devices a process: on 4 processes a block row
# takes rows from two later processes); a height no global device count
# divides.
PLANES = (("even", 128, 128, "qtable", 4), ("h48", 48, 40, "qtable", 4),
          ("short", 32, 40, "qtable", 4), ("padded", 40, 64, "none", 2),
          ("indivisible", 100, 40, "qtable", 4))
DTYPES = (("f32", None), ("f64", torch.float64))
BATCH_HW = (40, 56)
BATCH_N = 5


def synth_plane(name, h, w):
    if name == "padded":
        return np.random.default_rng(1).integers(0, 256, (h, w))
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    return np.clip(128 + 80 * np.sin(x / 7.0) * np.cos(y / 5.0)
                   + 25 * np.sin((x + 2 * y) / 11.0), 0, 255).astype(int)


def synth_image(h, w, seed):
    """(H, W, 3) uint8 YCbCr image, content varied by seed."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    bands = [np.clip(128 + 70 * np.sin(x / (5 + seed + k))
                     * np.cos(y / (7 + 2 * k)) + 10 * seed, 0, 255)
             for k in range(3)]
    return np.stack(bands, axis=-1).astype(np.uint8)


def _config(h, w, q="qtable"):
    from jpeg_tpu_torch import Configuration, QuantizationMethod
    return Configuration(width=w, height=h, block_size=2, dct_size=8,
                         quantization=QuantizationMethod(q))


def jax_rows(h, nproc, pid, ndev):
    """The JAX package's image rows of process ``pid`` with ``ndev``
    devices a process, computed by hand: ``h / (nproc * ndev)`` rows a
    device where that divides, else the whole (replicated) plane."""
    if h % (nproc * ndev):
        return 0, h
    per = h // (nproc * ndev) * ndev
    return pid * per, (pid + 1) * per


def child(port, nproc, pid, outdir):
    torch.set_num_threads(1)
    from jpeg_tpu_torch import parallel
    from jpeg_tpu_torch.parallel import multihost
    multihost.initialize(f"127.0.0.1:{port}", nproc, pid)
    try:
        assert multihost.process_count() == nproc
        assert multihost.process_index() == pid
        import jpeg_tpu_torch
        for name, h, w, q, ndev in PLANES:
            cfg = _config(h, w, q)
            mesh = parallel.make_mesh(devices=[torch.device("cpu")] * ndev)
            _, _, y0, y1 = multihost.host_rows(cfg, mesh=mesh)
            assert (y0, y1) == jax_rows(h, nproc, pid, ndev)
            plane = synth_plane(name, h, w)
            for tag, dtype in DTYPES:
                out = os.path.join(outdir, f"{{}}_{name}_{tag}_{pid}")
                if h % (nproc * ndev):
                    try:
                        multihost.compress_plane_distributed(
                            plane, cfg, mesh, dtype=dtype)
                    except ValueError as e:
                        with open(out.format("raised"), "w") as f:
                            f.write(str(e))
                    stream = jpeg_tpu_torch.compress_band(
                        plane, cfg, dtype, device="cpu")
                else:
                    if name == "h48" and dtype is None:
                        # one process's slice one row short: every process
                        # raises, none waits in a collective
                        short = plane[y0:y1 - (pid == nproc - 1)]
                        try:
                            multihost.compress_plane_distributed(
                                short, cfg, mesh, dtype=dtype)
                        except ValueError as e:
                            with open(out.format("badshape"), "w") as f:
                                f.write(str(e))
                    stream = multihost.compress_plane_distributed(
                        plane[y0:y1], cfg, mesh, dtype=dtype)
                    with open(out.format("stream") + ".bin", "wb") as f:
                        f.write(stream)
                np.save(out.format("rows") + ".npy",
                        multihost.decompress_plane_distributed(
                            stream, cfg, mesh, dtype=dtype))

        # Batch phase: only OWNED images may ever be loaded.
        cfg = _config(*BATCH_HW)

        def loader(i):
            def load():
                assert i % nproc == pid, f"{pid} loaded foreign image {i}"
                return synth_image(*BATCH_HW, i)
            return load

        blobs, manifest = multihost.compress_batch_distributed(
            [loader(i) for i in range(BATCH_N)], cfg, verify=True,
            device="cpu")
        np.save(os.path.join(outdir, f"manifest_{pid}.npy"), manifest)
        for i, blob in enumerate(blobs):
            assert (blob is not None) == (i % nproc == pid), (i, pid)
            if blob is not None:
                with open(os.path.join(outdir, f"batch_{i}.bin"), "wb") as f:
                    f.write(blob)
    finally:
        multihost.shutdown()
    print("child done", pid, flush=True)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def run_group(argvs, timeout=CHILD_TIMEOUT_S):
    """Start one process per argv; wait for all with a deadline, killing
    every process once one fails or the deadline passes.  Returns
    ``(return codes, outputs)``."""
    procs = [subprocess.Popen(a, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=REPO)
             for a in argvs]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = any(p.poll() not in (None, 0) for p in procs)
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = [p.communicate(timeout=30)[0] for p in procs]
    return [p.returncode for p in procs], outs


def _check_group(nproc, tmp_path):
    port = _free_port()
    rcs, outs = run_group([[sys.executable, os.path.abspath(__file__),
                            str(port), str(nproc), str(pid), str(tmp_path)]
                           for pid in range(nproc)])
    for pid, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"child {pid} failed ({rc}):\n{out}"

    import jpeg_tpu
    from jpeg_tpu import api as japi
    import jpeg_tpu_torch
    for name, h, w, q, ndev in PLANES:
        cfg = _config(h, w, q)
        plane = synth_plane(name, h, w)
        want = jpeg_tpu_torch.compress_band(plane, cfg, device="cpu")
        jcfg = jpeg_tpu.Configuration(
            width=w, height=h, block_size=2, dct_size=8,
            quantization=jpeg_tpu.QuantizationMethod(q))
        want64 = japi.compress_band(plane, jcfg, dtype=np.float64)
        for (tag, dtype), ref in zip(DTYPES, (want, want64)):
            if h % (nproc * ndev):
                for pid in range(nproc):
                    msg = (tmp_path / f"raised_{name}_{tag}_{pid}") \
                        .read_text()
                    assert f"divisible by {nproc * ndev} devices" in msg
            else:
                if name == "h48" and dtype is None:
                    for pid in range(nproc):
                        msg = (tmp_path / f"badshape_{name}_{tag}_{pid}") \
                            .read_text()
                        assert f"process {nproc - 1} of {nproc}" in msg
                streams = [(tmp_path / f"stream_{name}_{tag}_{pid}.bin")
                           .read_bytes() for pid in range(nproc)]
                assert all(s == streams[0] for s in streams), \
                    f"{name} {tag}: processes disagree"
                assert streams[0] == ref, f"{name} {tag}: stitched != serial"
            serial = jpeg_tpu_torch.decompress_band(ref, cfg, dtype,
                                                    device="cpu")
            for pid in range(nproc):
                y0, y1 = jax_rows(h, nproc, pid, ndev)
                np.testing.assert_array_equal(
                    np.load(tmp_path / f"rows_{name}_{tag}_{pid}.npy"),
                    serial[y0:y1], err_msg=f"{name} {tag} process {pid}")

    bcfg = _config(*BATCH_HW)
    manifests = [np.load(tmp_path / f"manifest_{pid}.npy")
                 for pid in range(nproc)]
    for m in manifests[1:]:
        np.testing.assert_array_equal(manifests[0], m)
    for i in range(BATCH_N):
        want_blob = jpeg_tpu_torch.compress_ycbcr(synth_image(*BATCH_HW, i),
                                                  bcfg, device="cpu")
        assert (tmp_path / f"batch_{i}.bin").read_bytes() == want_blob, i
        assert manifests[0][i, 0] == len(want_blob)
        assert manifests[0][i, 1] == 1
        assert manifests[0][i, 2] > 20000          # PSNR > 20 dB (milli-dB)


def test_two_process_distributed_stitch(tmp_path):
    _check_group(2, tmp_path)


def test_four_process_distributed_stitch(tmp_path):
    _check_group(4, tmp_path)


def _write_png(path, h, w):
    from PIL import Image
    y, x = np.mgrid[0:h, 0:w]
    arr = np.stack([128 + 60 * np.sin(x / 7.0),
                    128 + 60 * np.cos(y / 9.0),
                    (255.0 * (x + y)) / (h + w)], axis=-1)
    Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8), "RGB").save(path)


def test_batch_cli_distributed_two_process(tmp_path):
    """A real 2-process ``--distributed`` CLI run: each process writes only
    its owned outputs; the union equals a serial run byte for byte and both
    metrics lines agree on the global bytes."""
    from jpeg_tpu_torch.cli import batch
    indir, outdir = tmp_path / "in", tmp_path / "dist"
    indir.mkdir()
    for i, (h, w) in enumerate([(24, 32), (24, 32), (16, 16), (24, 32)]):
        _write_png(indir / f"img{i}.png", h, w)
    serial_out = tmp_path / "serial"
    args = batch.build_parser().parse_args(
        [str(indir), str(serial_out), "--block_size", "2", "--device", "cpu"])
    assert batch.run(str(indir), str(serial_out), args).failures == 0

    port = _free_port()
    rcs, outs = run_group([
        [sys.executable, "-m", "jpeg_tpu_torch", "batch", str(indir),
         str(outdir), "--block_size", "2", "--device", "cpu",
         "--distributed", "--coordinator", f"127.0.0.1:{port}",
         "--nproc", "2", "--procid", str(pid)] for pid in range(2)])
    for pid, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"process {pid} failed ({rc}):\n{out}"
    assert sorted(os.listdir(outdir)) == sorted(os.listdir(serial_out))
    for f in os.listdir(serial_out):
        assert (outdir / f).read_bytes() == (serial_out / f).read_bytes(), f
    lines = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert lines[0]["compressed_bytes"] == lines[1]["compressed_bytes"]
    assert lines[0]["images"] == 4 and lines[1]["images"] == 4


if __name__ == "__main__":
    child(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
