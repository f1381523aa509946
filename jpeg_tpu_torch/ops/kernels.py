"""The codec's GPU kernels: wrappers, plain PyTorch versions, counts.

Counterpart of ``jpeg_tpu/ops/pallas_kernels.py``.  Each
kernel is CUDA C++ under ``jpeg_tpu_torch/csrc/``, compiled by ``nvcc`` for
``sm_90a`` at first use into ``build/cuda/<source hash>/`` and loaded with
ctypes (plain C entry points, see ``csrc/common.cuh``).

=========================  =======================  ========================
wrapper                    source                   replaces (Pallas)
=========================  =======================  ========================
encode_stream_rows         csrc/encode_stream.cu    _encode_stream_lv_kernel
encode_stream_rows_tables  csrc/encode_tables.cu    _encode_stream_kernel
deposit_rows               csrc/compact.cu          _merge_rows_kernel +
                                                    compact_rows' gather
decode_stream_blocks       csrc/decode_stream.cu    _decode_stream_kernel
decode_blocks              csrc/decode_blocks.cu    _decode_kernel
encode_blocks              csrc/encode_blocks.cu    _encode_kernel
scan_walk                  csrc/scan_walk.cu        _scan_walk_kernel_single
scan_walk_resume           csrc/scan_walk.cu        _scan_walk_kernel
                                                    (two-sweep form)
scan_walk_capped           csrc/scan_walk.cu        the same, as sweep 1 of
                                                    its table
chase_starts               csrc/chase.cu            _chase_kernel
chase_starts_multi         csrc/chase.cu            _chase_multi_kernel
segment_scan               csrc/segment_scan.cu     none: replaces K6 + K8's
                                                    long form on long bands
=========================  =======================  ========================

Dispatch is by the device of the tensors a wrapper is given: CPU tensors
take the plain PyTorch version (``*_plain``, which also runs on CUDA
tensors when called directly, so a kernel can be held against it on the
card); CUDA tensors launch the kernel or raise.  Nothing falls back from a
CUDA tensor to the plain version.  Each wrapper counts its kernel launches
in its ``launches`` attribute (:func:`launch_counts`).
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time
from typing import NamedTuple

import torch

from ..utils.device import full_f32_matmul
from .quantize import epilogue

MAX_RUN = 15
MAX_SIZE = 15

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "cuda")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
_lib_lock = threading.Lock()

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_PI64 = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    # levels, n, L, W, lanes, tile, smem rows, rows, blk_bytes, device,
    # stream
    "jt_encode_rows": (_P, _I64, _I32, _I32, _I32, _I32, _I32, _P, _P, _I32,
                       _P),
    # cbits, vhi, vlo, n, L + 1, W, lanes, tile, smem rows, rows, device,
    # stream
    "jt_encode_tables": (_P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32, _P,
                         _I32, _P),
    # rows, blk_bytes, n, W, out, cap, tile status scratch, device, stream
    "jt_deposit_rows": (_P, _P, _I64, _I32, _P, _I64, _P, _I32, _P),
    # stream bytes, nbytes, starts, n, L, tile, halo, out, device, stream
    "jt_decode_stream": (_P, _I64, _P, _I64, _I32, _I32, _I32, _P, _I32, _P),
    # levels, deq, op_t, n, K, M, bs, out, device, stream
    "jt_decode_blocks": (_P, _P, _P, _I64, _I32, _I32, _I32, _P, _I32, _P),
    # levels, deq, op_t, n, K, M, out (N, M) f32, device, stream: K4's sums
    # before its epilogue
    "jt_decode_blocks_sums": (_P, _P, _P, _I64, _I32, _I32, _P, _I32, _P),
    # x, op_t, mul, div, mask, n, K, L, out, device, stream
    "jt_encode_blocks": (_P, _P, _P, _P, _P, _I64, _I32, _I32, _P, _I32, _P),
    # x, op_t, n, K, L, out (N, L) f32, device, stream: K5's sums before
    # its epilogue
    "jt_encode_blocks_sums": (_P, _P, _I64, _I32, _I32, _P, _I32, _P),
    # stream bytes, P, limit bits, L, tile, halo, end table, device, stream
    "jt_scan_walk": (_P, _I64, _I64, _I32, _I32, _I32, _P, _I32, _P),
    # stream bytes, P, limit bits, L, cap, tile, halo, end table,
    # survivors' bytes, bits, indices and count, device, stream
    "jt_scan_walk_capped": (_P, _I64, _I64, _I32, _I32, _I32, _I32, _P, _P,
                            _P, _P, _P, _I32, _P),
    # stream bytes, P, limit bits, L, q, c0, w0, M, n_live, steps, blocks,
    # end table, lengths, bits, indices, device, stream
    "jt_scan_walk_resume": (_P, _I64, _I64, _I32, _P, _P, _P, _I64, _P, _I32,
                            _I32, _P, _P, _P, _P, _I32, _P),
    # end table, P2, target, s0, nb, jump table, anchors, starts, ok,
    # device, stream
    "jt_chase": (_P, _I64, _I64, _I64, _I64, _P, _P, _P, _P, _I32, _P),
    # end table, P2, targets, s0s, B, nb, jump table, anchors, starts, ok,
    # device, stream
    "jt_chase_multi": (_P, _I64, _P, _P, _I64, _I64, _P, _P, _P, _P, _I32,
                       _P),
    # stream bytes, P, firsts, ends (host arrays), B, segment bytes, halo,
    # L, nb, scratch, walker slots, starts, status, device, stream
    "jt_segment_scan": (_P, _I64, _PI64, _PI64, _I64, _I32, _I32, _I32, _I64,
                        _P, _I64, _P, _P, _I32, _P),
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                       "the CUDA kernels are built from jpeg_tpu_torch/csrc "
                       "at first use")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path() -> str:
    """Where the built kernel library lives: keyed by the hash of every
    source and header in ``csrc/`` and of the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16],
                        "libjpeg_tpu_torch_kernels.so")


def build() -> str:
    """Compile ``csrc/*.cu`` into one shared library unless it exists.

    One ``nvcc`` per source, all started together, then one link.  Returns
    the library's path.  ``nvcc``'s output (``-Xptxas -v``: registers,
    shared memory and spills per kernel) is kept beside it in ``build.log``.
    """
    so = library_path()
    if os.path.exists(so):
        return so
    out_dir = os.path.dirname(so)
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = os.path.join(out_dir, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", src, "-o", obj]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], False
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        log.append(f"$ {' '.join(cmd)}\n{out}[exit {proc.returncode}]\n")
        failed |= proc.returncode != 0
    tmp = f"{so}.{tag}"
    if not failed:
        cmd = [nvcc, "-shared", "-o", tmp, *(obj for _, obj, _ in jobs)]
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        log.append(f"$ {' '.join(cmd)}\n{res.stdout}[exit {res.returncode}]\n")
        failed = res.returncode != 0
    for _, obj, _ in jobs:
        if os.path.exists(obj):
            os.remove(obj)
    log.append(f"[{time.perf_counter() - t0:.1f} s]\n")
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write("".join(log))
    if failed:
        raise RuntimeError("nvcc failed building the CUDA kernels:\n"
                           + "".join(log))
    os.replace(tmp, so)
    return so


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.jt_error_string.argtypes = (ctypes.c_int,)
            lib.jt_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


_count_lock = threading.Lock()


def _count(wrapper) -> None:
    """One launch of ``wrapper``'s kernel.  The pipelined API launches from
    a worker thread as well as the caller's, so the update takes a lock."""
    with _count_lock:
        wrapper.launches += 1


def _launch(name: str, device: torch.device, *args) -> None:
    lib = _library()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, name)(*args, device.index, stream)
    if err != 0:
        msg = lib.jt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} ({err})")


def _check(t, name: str, dtype: torch.dtype, ndim: int) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name} must be a {ndim}-d {dtype} tensor, got "
                         f"{t.dim()}-d {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_cuda(*tensors) -> bool:
    """True: launch the kernel; False: run the plain version.  Raises for
    mixed devices or a device with neither."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("tensors on different devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {dev}: use a CUDA or CPU tensor")


def _ceil16(n: int) -> int:
    return -(-n // 16) * 16


def _to_i32_words(w: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same bit pattern."""
    return (w - ((w >> 31) << 32)).to(torch.int32)


# ---------------------------------------------------------------------------
# K1: levels -> stream-word rows + block bytes (csrc/encode_stream.cu)
# ---------------------------------------------------------------------------

# K1's and K9's plan (csrc/bit_writer.cuh): a group of `lanes` lanes writes
# one block's row, each lane owning ceil(S / lanes) consecutive slots of the
# block's S (L levels for K1, L + 1 table slots for K9).  One lane a block
# walks its slots once, writing as it counts; a group walks them twice
# (count, then write), shorter, and joins its pieces by warp scans.  One
# lane a block pays once there are ENC_ONE_LANE_BLOCKS blocks an SM per 64
# slots a block (a longer walk needs more blocks to hide it); below that
# the plan takes the fewest lanes of ENC_LANES that give the card
# ENC_WAVE_LANES lanes an SM, or one slot a lane.  Both numbers were fitted
# on an H100 (132 SMs) to the device times of every group size at the 43
# (kernel, L, N) points that chip_smoke.py's plan sweep times, L = 9 ...
# 1,024 and N = 768 ... 350,892 (PERF.md, K1's and K9's plan): they put
# each point within 28 % of its fastest group size, 4 % on average.  Two
# lanes a block never won, so there is no kernel for them.  A thread block
# of at most ENC_THREADS threads (the kernels' kEncThreads) takes a tile
# of consecutive blocks and stages their slots (4 bytes each, at an odd
# stride; K9 both its group lengths and their low words), their block
# bytes and, up to ENC_ROW_MAX_WORDS words a row (kEncRowMaxWords), their
# rows in shared memory; the tile halves while that exceeds
# ENC_STAGE_BYTES, the lanes growing to keep a warp, down to one block.
# Longer rows are written in global memory by the same lanes.
# ENC_MAX_L bounds the slots so a one-block tile fits the card's shared
# memory (ENC_MAX_SMEM, kEncMaxSmem).
ENC_THREADS = 128
ENC_LANES = (1, 4, 8, 16, 32)
ENC_ONE_LANE_BLOCKS = 96
ENC_WAVE_LANES = 256
ENC_STAGE_BYTES = 48 << 10
ENC_ROW_MAX_WORDS = 512
ENC_MAX_SMEM = 227 << 10
ENC_MAX_L = 1 << 14


class EncodeRowsPlan(NamedTuple):
    lanes: int        # lanes a block (one of ENC_LANES)
    tile: int         # consecutive blocks a thread block writes
    smem_rows: bool   # rows staged in shared memory, else written in place


def encode_rows_smem(S: int, W: int, plan: EncodeRowsPlan,
                     tables: int = 1) -> int:
    """Shared-memory bytes of a tile (``EncTile::smem_bytes``): its staged
    rows, block bytes and ``tables`` tables of slots (K1: 1, K9: 2), each
    region a multiple of 16 bytes but the tables, at an odd stride."""
    r4 = lambda x: -(-x // 4) * 4                       # noqa: E731
    return 4 * ((r4(plan.tile * W) if plan.smem_rows else 0)
                + r4(plan.tile) + tables * plan.tile * (S | 1))


def encode_rows_fit(lanes: int, S: int, W: int,
                    tables: int = 1) -> EncodeRowsPlan:
    """The tile for ``lanes`` lanes a block: ENC_THREADS threads' worth,
    halved while its shared memory exceeds ENC_STAGE_BYTES (the lanes
    growing to keep a warp)."""
    plan = EncodeRowsPlan(lanes, max(ENC_THREADS // lanes, 1),
                          W <= ENC_ROW_MAX_WORDS)
    while (plan.tile > 1
           and encode_rows_smem(S, W, plan, tables) > ENC_STAGE_BYTES):
        plan = plan._replace(tile=plan.tile // 2)
        if plan.tile * plan.lanes < 32:
            plan = plan._replace(lanes=max(2 * plan.lanes, ENC_LANES[1]))
    return plan


@functools.lru_cache(maxsize=256)
def encode_rows_plan(n: int, S: int, W: int, sms: int,
                     tables: int = 1) -> EncodeRowsPlan:
    """How K1 (S = L levels, one table) and K9 (S = L + 1 slots, two
    tables) cut n blocks into thread blocks at row width W on a card of
    ``sms`` SMs (see the constants above)."""
    lanes = 1
    if n * 64 < ENC_ONE_LANE_BLOCKS * sms * max(S, 64):
        lanes = next((g for g in ENC_LANES[1:]
                      if g >= S or n * g >= ENC_WAVE_LANES * sms),
                     ENC_LANES[-1])
    return encode_rows_fit(lanes, S, W, tables)


def _check_width(W: int) -> None:
    if W < 1:
        raise ValueError(f"row width W must be >= 1 word, got {W}")


def _check_slots(S: int) -> None:
    """The kernels' bound on a block's slots (the plain versions have
    none)."""
    if S > ENC_MAX_L:
        raise ValueError(f"{S} slots a block: at most {ENC_MAX_L} on the "
                         "card")


class _RowWriter:
    """Vectorised serial bit writer (the plain versions' counterpart of
    ``csrc/bit_writer.cuh``): one int64 bit accumulator per block; words
    leave it at 32 bits, and words past a row's W go to a sink column
    (counted, not stored)."""

    def __init__(self, n: int, W: int, device):
        z = torch.zeros(n, dtype=torch.int64, device=device)
        self.W = W
        self.rows = torch.zeros((n, W + 1), dtype=torch.int64, device=device)
        self.ar = torch.arange(n, device=device)
        self.acc = self.nacc = self.wi = self.total = z

    def _store(self, on, word):
        col = torch.where(on, self.wi.clamp(max=self.W), self.W)
        self.rows[self.ar, col] = torch.where(on, word, 0)
        self.wi = self.wi + on.to(torch.int64)

    def append(self, nbits, val):
        """Append the low ``nbits`` (<= 32) bits of ``val``, MSB first."""
        acc = (self.acc << nbits) | val
        nacc = self.nacc + nbits
        full = nacc >= 32
        self.nacc = torch.where(full, nacc - 32, nacc)
        self._store(full, (acc >> self.nacc) & 0xFFFFFFFF)
        self.acc = torch.where(full, acc & ((1 << self.nacc) - 1), acc)
        self.total = self.total + nbits

    def finish(self):
        tail = self.nacc > 0
        self._store(tail, (self.acc << (32 - self.nacc).clamp(max=31))
                     & 0xFFFFFFFF)
        return (_to_i32_words(self.rows[:, :self.W]),
                (self.total >> 3).to(torch.int32))


def encode_stream_rows_plain(levels: torch.Tensor, W: int):
    """Plain version of K1: a loop over the L slots, vectorised over blocks,
    in int64.  Returns ((N, W) int32 big-endian word rows, (N,) int32 block
    bytes); bytes of a block longer than 4*W are counted but not stored."""
    n, L = levels.shape
    lv = levels.to(torch.int64)
    bw = _RowWriter(n, W, levels.device)
    zero = torch.zeros_like(bw.total)
    prev = torch.full_like(zero, -1)
    for s in range(L):
        a = lv[:, s]
        nz = a != 0
        absa = a.abs()
        bitlen = torch.frexp(absa.to(torch.float64))[1].to(torch.int64)
        size = torch.where(nz, (bitlen + 1).clamp(max=MAX_SIZE), 1)
        run = s - prev - 1
        nch = torch.div(run, MAX_RUN, rounding_mode="floor")
        rrem = run - nch * MAX_RUN
        for c in range((L - 1) // MAX_RUN):
            on = nz & (c < nch)
            bw.append(torch.where(on, 8, 0), torch.where(on, 0xF0, 0))
        mag = absa & ((1 << (size - 1)) - 1)
        code = ((rrem << (4 + size)) | (size << size)
                | ((a > 0).to(torch.int64) << (size - 1)) | mag)
        bw.append(torch.where(nz, 8 + size, 0), torch.where(nz, code, 0))
        prev = torch.where(nz, s, prev)
    bw.append(zero + 8, zero)                                # EOB
    bw.append((-bw.total) & 7, zero)                         # pad to a byte
    return bw.finish()


def _encode_rows(levels: torch.Tensor, W: int, plan: EncodeRowsPlan):
    """Launch K1 on the levels' device with ``plan`` (the wrapper counts
    the launch)."""
    n, L = levels.shape
    rows = torch.empty((n, W), dtype=torch.int32, device=levels.device)
    blk_bytes = torch.empty(n, dtype=torch.int32, device=levels.device)
    if n:
        _launch("jt_encode_rows", levels.device, levels.data_ptr(), n, L, W,
                plan.lanes, plan.tile, int(plan.smem_rows), rows.data_ptr(),
                blk_bytes.data_ptr())
    return rows, blk_bytes


def encode_stream_rows(levels: torch.Tensor, W: int):
    """(N, L) int32 levels -> ((N, W) int32 stream-word rows, (N,) int32
    block bytes).  Row i is block i's bytes, top-justified big-endian words,
    zero-padded; a block longer than 4*W bytes is truncated in its row (its
    count stays exact), so callers check ``blk_bytes <= 4*W``.  Levels must
    satisfy |a| <= 16383 (callers check the max first).  On the card L is
    at most ``ENC_MAX_L``, and the kernel writes every word of both
    outputs (one launch a call)."""
    _check(levels, "levels", torch.int32, 2)
    _check_width(W)
    if not _on_cuda(levels):
        return encode_stream_rows_plain(levels, W)
    n, L = levels.shape
    _check_slots(L)
    out = _encode_rows(levels, W, encode_rows_plan(
        n, L, W, _multiprocessors(levels.device)))
    if n:
        _count(encode_stream_rows)
    return out


# ---------------------------------------------------------------------------
# K9: unit-group tables -> stream-word rows (csrc/encode_tables.cu)
# ---------------------------------------------------------------------------

_MAX_GROUP_BITS = 64


def encode_stream_rows_tables_plain(cbits: torch.Tensor, vhi: torch.Tensor,
                                    vlo: torch.Tensor, W: int) -> torch.Tensor:
    """Plain version of K9: a loop over the L + 1 slots, vectorised over
    blocks, appending each group as its high ``c - 32`` bits (when
    ``c > 32``) and then its low bits through :class:`_RowWriter`."""
    n, L1 = cbits.shape
    bw = _RowWriter(n, W, cbits.device)
    mask32 = (1 << 32) - 1
    for s in range(L1):
        c = cbits[:, s].to(torch.int64).clamp(0, _MAX_GROUP_BITS)
        hi = vhi[:, s].to(torch.int64) & mask32
        lo = vlo[:, s].to(torch.int64) & mask32
        nhi = (c - 32).clamp(min=0)
        bw.append(nhi, hi & ((1 << nhi) - 1))
        nlo = c - nhi
        bw.append(nlo, lo & ((1 << nlo) - 1))
    return bw.finish()[0]


def _encode_tables(cbits: torch.Tensor, vhi: torch.Tensor,
                   vlo: torch.Tensor, W: int,
                   plan: EncodeRowsPlan) -> torch.Tensor:
    """Launch K9 on the tables' device with ``plan`` (the wrapper counts
    the launch)."""
    n, L1 = cbits.shape
    rows = torch.empty((n, W), dtype=torch.int32, device=cbits.device)
    if n:
        _launch("jt_encode_tables", cbits.device, cbits.data_ptr(),
                vhi.data_ptr(), vlo.data_ptr(), n, L1, W, plan.lanes,
                plan.tile, int(plan.smem_rows), rows.data_ptr())
    return rows


def encode_stream_rows_tables(cbits: torch.Tensor, vhi: torch.Tensor,
                              vlo: torch.Tensor, W: int) -> torch.Tensor:
    """(N, L+1) int32 unit-group tables (``entropy/device_codec.py:
    _unit_groups``) -> (N, W) int32 stream-word rows, the same rows as
    :func:`encode_stream_rows` writes from the levels: slot s of block i
    appends ``cbits[i, s]`` (0..64) bits of ``(vhi << 32) | vlo``.  A block
    longer than 4*W bytes is truncated in its row; callers check the block
    bytes, which ``_unit_groups`` returns, against 4*W."""
    for name, t in (("cbits", cbits), ("vhi", vhi), ("vlo", vlo)):
        _check(t, name, torch.int32, 2)
    if vhi.shape != cbits.shape or vlo.shape != cbits.shape:
        raise ValueError(f"tables of shapes {tuple(cbits.shape)}, "
                         f"{tuple(vhi.shape)}, {tuple(vlo.shape)} differ")
    _check_width(W)
    if not _on_cuda(cbits, vhi, vlo):
        return encode_stream_rows_tables_plain(cbits, vhi, vlo, W)
    n, L1 = cbits.shape
    _check_slots(L1)
    rows = _encode_tables(cbits, vhi, vlo, W, encode_rows_plan(
        n, L1, W, _multiprocessors(cbits.device), tables=2))
    if n:
        _count(encode_stream_rows_tables)
    return rows


# ---------------------------------------------------------------------------
# K2: rows + block bytes -> contiguous stream (csrc/compact.cu)
# ---------------------------------------------------------------------------

def deposit_rows_plain(rows: torch.Tensor, blk_bytes: torch.Tensor,
                       cap: int) -> torch.Tensor:
    """Plain version of K2: every byte's stream position by index
    arithmetic, then one scatter.  Returns (cap,) uint8."""
    n, W = rows.shape
    dev = rows.device
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int32, device=dev)
    b = ((rows.unsqueeze(-1) >> shifts) & 0xFF).reshape(n, 4 * W)
    j = torch.arange(4 * W, device=dev)
    bb = blk_bytes.to(torch.int64)
    pos = (torch.cumsum(bb, 0) - bb)[:, None] + j[None, :]
    keep = (j[None, :] < blk_bytes[:, None].to(torch.int64)) & (pos < cap)
    out = torch.zeros(cap + 1, dtype=torch.uint8, device=dev)  # [cap]: sink
    out[torch.where(keep, pos, cap)] = torch.where(keep, b, 0).to(torch.uint8)
    return out[:cap]


# K2's tile: blocks a thread block scans and deposits (csrc/compact.cu's
# kTileBlocks); the kernel keeps one 64-bit status word a tile.
DEPOSIT_TILE_BLOCKS = 256


def deposit_rows(rows: torch.Tensor, blk_bytes: torch.Tensor,
                 cap: int) -> torch.Tensor:
    """(N, W) int32 rows + (N,) int32 block bytes -> (cap,) uint8 buffer
    whose first ``blk_bytes.sum()`` bytes are the concatenated block
    streams (the rest zero).  Nothing past ``cap`` is written: callers that
    size ``cap`` check the sum against it.  On the card the kernel takes
    the prefix sum and writes every byte of the buffer itself (two
    launches, counted as one)."""
    _check(rows, "rows", torch.int32, 2)
    _check(blk_bytes, "blk_bytes", torch.int32, 1)
    if blk_bytes.shape[0] != rows.shape[0]:
        raise ValueError(f"{rows.shape[0]} rows but {blk_bytes.shape[0]} "
                         "block byte counts")
    if cap < 0:
        raise ValueError(f"cap must be >= 0, got {cap}")
    if not _on_cuda(rows, blk_bytes):
        return deposit_rows_plain(rows, blk_bytes, cap)
    n, W = rows.shape
    if not (n and cap):
        return torch.zeros(cap, dtype=torch.uint8, device=rows.device)
    out = torch.empty(cap, dtype=torch.uint8, device=rows.device)
    status = torch.empty(-(-n // DEPOSIT_TILE_BLOCKS), dtype=torch.int64,
                         device=rows.device)
    _launch("jt_deposit_rows", rows.device, rows.data_ptr(),
            blk_bytes.data_ptr(), n, W, out.data_ptr(), cap,
            status.data_ptr())
    _count(deposit_rows)
    return out


# ---------------------------------------------------------------------------
# K3: stream bytes + block starts -> (N, L) levels (csrc/decode_stream.cu)
# ---------------------------------------------------------------------------

def decode_stream_blocks_plain(stream: torch.Tensor, starts: torch.Tensor,
                               L: int) -> torch.Tensor:
    """Plain version of K3: a loop over the L + L//15 + 2 code steps,
    vectorised over blocks."""
    n = starts.shape[0]
    dev = stream.device
    nbytes = stream.shape[0]
    pad = torch.cat([stream.to(torch.int64),
                     torch.zeros(5, dtype=torch.int64, device=dev)])
    pos = starts.to(torch.int64) * 8
    widx = torch.zeros(n, dtype=torch.int64, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    out = torch.zeros((n, L + 1), dtype=torch.int32, device=dev)  # col L: sink
    ar = torch.arange(n, device=dev)
    for _ in range(L + L // MAX_RUN + 2):
        byte = (pos >> 3).clamp(0, nbytes)
        v = torch.zeros_like(pos)
        for j in range(5):
            v = (v << 8) | pad[byte + j]
        win = (v >> (8 - (pos & 7))) & 0xFFFFFFFF
        run = win >> 28
        size = (win >> 24) & 0xF
        eob = (run == 0) & (size == 0)
        chain = (run == MAX_RUN) & (size == 0)
        active = ~done
        nmag = (size - 1).clamp(min=0)
        mag = (win >> (23 - nmag)) & ((1 << nmag) - 1)
        amp = torch.where(((win >> 23) & 1) == 1, mag, -mag)
        wt = widx + run
        store = active & ~eob & ~chain & (wt < L)
        out[ar, torch.where(store, wt, L)] = torch.where(
            store, amp, 0).to(torch.int32)
        widx = torch.where(active & chain, widx + MAX_RUN,
                           torch.where(store, wt + 1, widx))
        adv = torch.where(chain, 8, 8 + size)
        pos = torch.where(active & ~eob, pos + adv, pos)
        done = done | (active & eob)
    return out[:, :L].contiguous()


# K3's tiles (csrc/decode_stream.cu): a thread block of DECODE_TILE_MAX
# threads (the kernel's kThreads) decodes up to that many consecutive
# blocks, keeps their levels in shared memory and stages at most
# DECODE_SPAN_BYTES (the kernel's kSpanBytes) of their stream.  The plan
# keeps a tile of more than one block within DECODE_LEVEL_BYTES of levels,
# the fastest size on an H100 (csrc/decode_stream.cu); the largest L fits
# a tile of one block in the card's shared memory.
DECODE_TILE_MAX = 128
DECODE_LEVEL_BYTES = 12 << 10
DECODE_SPAN_BYTES = 4 << 10
DECODE_MAX_L = 1 << 15


def block_max_bytes(L: int) -> int:
    """The longest block the encoder writes at L: every coefficient a code
    of size 15 (8 + 15 bits), then EOB, padded to a byte."""
    return ((8 + MAX_SIZE) * L + 8 + 7) // 8


class DecodeStreamPlan(NamedTuple):
    tile: int        # consecutive blocks per thread block
    halo: int        # bytes staged past the tile's last start


def decode_stream_plan(L: int) -> DecodeStreamPlan:
    """How K3 cuts N blocks of L coefficients: tiles of the most blocks,
    halving from ``DECODE_TILE_MAX``, whose levels fit in
    ``DECODE_LEVEL_BYTES`` (at least one block), each staging its span
    plus a halo of the longest block and the two words its bit buffer can
    read past the block's EOB, rounded up to 16 bytes."""
    tile = DECODE_TILE_MAX
    while tile > 1 and 4 * L * tile > DECODE_LEVEL_BYTES:
        tile //= 2
    return DecodeStreamPlan(tile, _ceil16(block_max_bytes(L) + 8))


def _decode_stream(stream: torch.Tensor, starts: torch.Tensor, L: int,
                   plan: DecodeStreamPlan) -> torch.Tensor:
    """Launch K3 on the stream's device with ``plan`` (the wrapper counts
    the launch)."""
    n = starts.shape[0]
    out = torch.empty((n, L), dtype=torch.int32, device=stream.device)
    if n:
        _launch("jt_decode_stream", stream.device, stream.data_ptr(),
                stream.shape[0], starts.data_ptr(), n, L, plan.tile,
                plan.halo, out.data_ptr())
    return out


def decode_stream_blocks(stream: torch.Tensor, starts: torch.Tensor,
                         L: int) -> torch.Tensor:
    """(nbytes,) uint8 stream + (N,) int64 block start offsets -> (N, L)
    int32 levels.  Bytes outside the stream read as zero (EOB), so starts
    need not be valid: a device scan's are decoded before its check is
    read.  On the card the kernel writes every element of the output (one
    launch a call)."""
    _check(stream, "stream", torch.uint8, 1)
    _check(starts, "starts", torch.int64, 1)
    if not 1 <= L <= DECODE_MAX_L:
        raise ValueError(f"L must be in [1, {DECODE_MAX_L}], got {L}")
    if not _on_cuda(stream, starts):
        return decode_stream_blocks_plain(stream, starts, L)
    out = _decode_stream(stream, starts, L, decode_stream_plan(L))
    if starts.shape[0]:
        _count(decode_stream_blocks)
    return out


# ---------------------------------------------------------------------------
# K4: dequantize + decode operator + round/clamp (csrc/decode_blocks.cu)
# ---------------------------------------------------------------------------

def _inflate_side(M: int, bs: int) -> int:
    """The block side d of a (K, M) operator whose pixels K4 writes to
    their bs x bs places: raises on a ``bs`` below 1, or on an M that is
    not d * d where bs > 1 (at bs 1 any M is taken, and d is 0)."""
    if not isinstance(bs, int) or bs < 1:
        raise ValueError(f"bs must be an int >= 1, got {bs!r}")
    if bs == 1:
        return 0
    d = math.isqrt(M)
    if d * d != M:
        raise ValueError(f"bs {bs} needs op_t (K, d*d), got width {M}")
    return d


def inflate_blocks(pix: torch.Tensor, bs: int) -> torch.Tensor:
    """(N, d*d) pixel blocks -> (N, (d*bs)**2): pixel (i, j) of each block
    at rows i*bs .. i*bs+bs-1 and columns j*bs .. j*bs+bs-1 of its
    (d*bs) x (d*bs) block, in row-major order (the nearest-neighbour
    inflate, as K4 stores it)."""
    d = _inflate_side(pix.shape[1], bs)
    if bs == 1:
        return pix
    n = pix.shape[0]
    return (pix.reshape(n, d, 1, d, 1).expand(n, d, bs, d, bs)
            .reshape(n, d * d * bs * bs))


def decode_blocks_plain(levels: torch.Tensor, op_t: torch.Tensor,
                        deq: torch.Tensor, bs: int = 1) -> torch.Tensor:
    """Plain version of K4: an f32 ``matmul`` in full f32 (see
    ``utils/device.py:full_f32_matmul``), round half to even, clamp, then
    :func:`inflate_blocks`."""
    _inflate_side(op_t.shape[1], bs)
    with full_f32_matmul():
        pix = torch.matmul((levels * deq).to(torch.float32), op_t)
    return inflate_blocks(torch.round(pix).clamp(0, 255).to(torch.uint8), bs)


def decode_blocks(levels: torch.Tensor, op_t: torch.Tensor,
                  deq: torch.Tensor, bs: int = 1) -> torch.Tensor:
    """(N, K) int32 levels, (K, M) f32 operator, (K,) int32 dequantizer ->
    (N, M * bs * bs) uint8: ``clamp(round((levels*deq) @ op_t), 0, 255)``,
    each pixel of a block written to its bs x bs places
    (:func:`inflate_blocks`; M must be d * d where bs > 1).  The kernel
    computes each of the M pixels once, whatever bs."""
    _check(levels, "levels", torch.int32, 2)
    _check(op_t, "op_t", torch.float32, 2)
    _check(deq, "deq", torch.int32, 1)
    n, K = levels.shape
    if op_t.shape[0] != K or deq.shape[0] != K:
        raise ValueError(f"levels (N, {K}) needs op_t ({K}, M) and deq "
                         f"({K},), got {tuple(op_t.shape)}, "
                         f"{tuple(deq.shape)}")
    M = op_t.shape[1]
    _inflate_side(M, bs)
    if not _on_cuda(levels, op_t, deq):
        return decode_blocks_plain(levels, op_t, deq, bs)
    out = torch.empty((n, M * bs * bs), dtype=torch.uint8,
                      device=levels.device)
    if n and M:
        _launch("jt_decode_blocks", levels.device, levels.data_ptr(),
                deq.data_ptr(), op_t.data_ptr(), n, K, M, bs, out.data_ptr())
        _count(decode_blocks)
    return out


def decode_blocks_sums(levels: torch.Tensor, op_t: torch.Tensor,
                       deq: torch.Tensor) -> torch.Tensor:
    """K4's f32 sums before its round and clamp, (N, M) f32, from the same
    tensor-core product on CUDA tensors (uncounted: no codec path calls it;
    ``chip_smoke.py`` measures the product's error with it).  The plain
    version is the full-f32 product of :func:`decode_blocks_plain`."""
    _check(levels, "levels", torch.int32, 2)
    _check(op_t, "op_t", torch.float32, 2)
    _check(deq, "deq", torch.int32, 1)
    if op_t.shape[0] != levels.shape[1] or deq.shape[0] != levels.shape[1]:
        raise ValueError("levels (N, K) needs op_t (K, M) and deq (K,)")
    if not _on_cuda(levels, op_t, deq):
        with full_f32_matmul():
            return torch.matmul((levels * deq).to(torch.float32), op_t)
    n, M = levels.shape[0], op_t.shape[1]
    out = torch.empty((n, M), dtype=torch.float32, device=levels.device)
    if n and M:
        _launch("jt_decode_blocks_sums", levels.device, levels.data_ptr(),
                deq.data_ptr(), op_t.data_ptr(), n, levels.shape[1], M,
                out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# K5: transform product + quantizer epilogue (csrc/encode_blocks.cu)
# ---------------------------------------------------------------------------

def encode_blocks_plain(x: torch.Tensor, op_t: torch.Tensor,
                        mul: torch.Tensor, div: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: an f32 ``matmul`` in full f32, then the
    quantizer epilogue (``ops/quantize.py:epilogue``)."""
    with full_f32_matmul():
        coeffs = torch.matmul(x, op_t)
    return epilogue(coeffs, mul, div, mask).to(torch.int32)


def encode_blocks(x: torch.Tensor, op_t: torch.Tensor, mul: torch.Tensor,
                  div: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(N, K) f32 pixel blocks, (K, L) f32 operator, three (L,) f32
    quantizer vectors -> (N, L) int32 ``round((x @ op_t) * mul / div) *
    mask``."""
    _check(x, "x", torch.float32, 2)
    _check(op_t, "op_t", torch.float32, 2)
    for name, v in (("mul", mul), ("div", div), ("mask", mask)):
        _check(v, name, torch.float32, 1)
    n, K = x.shape
    L = op_t.shape[1]
    if op_t.shape[0] != K or any(v.shape[0] != L for v in (mul, div, mask)):
        raise ValueError(f"x (N, {K}) needs op_t ({K}, L) and (L,) vectors, "
                         f"got {tuple(op_t.shape)}, {tuple(mul.shape)}, "
                         f"{tuple(div.shape)}, {tuple(mask.shape)}")
    if not _on_cuda(x, op_t, mul, div, mask):
        return encode_blocks_plain(x, op_t, mul, div, mask)
    out = torch.empty((n, L), dtype=torch.int32, device=x.device)
    if n and L:
        _launch("jt_encode_blocks", x.device, x.data_ptr(), op_t.data_ptr(),
                mul.data_ptr(), div.data_ptr(), mask.data_ptr(), n, K, L,
                out.data_ptr())
        _count(encode_blocks)
    return out


def encode_blocks_sums(x: torch.Tensor, op_t: torch.Tensor) -> torch.Tensor:
    """K5's f32 sums before its quantizer epilogue, (N, L) f32, from the
    same tensor-core product on CUDA tensors (uncounted: no codec path
    calls it; ``chip_smoke.py`` measures the product's error with it).  The
    plain version is the full-f32 product of :func:`encode_blocks_plain`."""
    _check(x, "x", torch.float32, 2)
    _check(op_t, "op_t", torch.float32, 2)
    if op_t.shape[0] != x.shape[1]:
        raise ValueError("x (N, K) needs op_t (K, L)")
    if not _on_cuda(x, op_t):
        with full_f32_matmul():
            return torch.matmul(x, op_t)
    n, L = x.shape[0], op_t.shape[1]
    out = torch.empty((n, L), dtype=torch.float32, device=x.device)
    if n and L:
        _launch("jt_encode_blocks_sums", x.device, x.data_ptr(),
                op_t.data_ptr(), n, x.shape[1], L, out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# K6: stream bytes -> speculative end table (csrc/scan_walk.cu)
# ---------------------------------------------------------------------------

def scan_walk_plain(stream: torch.Tensor, n_bytes: int,
                    L: int) -> torch.Tensor:
    """Plain version of K6: every byte position walks at once, one unit per
    step, for at most L + L//15 + 2 steps (``jpeg_tpu``'s
    ``device_scan._end_table_xla``, in int64, stopping once every walker
    has settled)."""
    P = stream.shape[0]
    dev = stream.device
    err = P + 1
    E = torch.full((P + 2,), err, dtype=torch.int32, device=dev)
    if P == 0:
        return E
    # 16-bit big-endian windows: the 8-bit header at bit position p is
    # w16[p >> 3] >> (8 - (p & 7)).
    b = torch.cat([stream.to(torch.int64),
                   torch.zeros(1, dtype=torch.int64, device=dev)])
    w16 = (b[:-1] << 8) | b[1:]
    limit = 8 * n_bytes
    pos = torch.arange(P, dtype=torch.int64, device=dev) * 8
    widx = torch.zeros(P, dtype=torch.int64, device=dev)
    done = torch.zeros(P, dtype=torch.bool, device=dev)
    bad = torch.zeros(P, dtype=torch.bool, device=dev)
    for _ in range(L + L // MAX_RUN + 2):
        live = ~(done | bad)
        if not bool(live.any()):
            break
        h = (w16[(pos >> 3).clamp(max=P - 1)] >> (8 - (pos & 7))) & 0xFF
        run = h >> 4
        size = h & 0xF
        eob = h == 0
        chain = h == 0xF0
        code = size != 0
        new_bad = live & ((pos + 8 > limit) | (~code & ~eob & ~chain)
                          | (code & (pos + 8 + size > limit))
                          | (code & (widx + run >= L)))
        npos = torch.where(code, pos + 8 + size, pos + 8)
        npos = torch.where(eob, (npos + 7) & ~7, npos)
        nwidx = widx + torch.where(chain, MAX_RUN,
                                   torch.where(code, run + 1, 0))
        upd = live & ~new_bad
        pos = torch.where(upd, npos, pos)
        widx = torch.where(upd, nwidx, widx)
        done = done | (upd & eob)
        bad = bad | new_bad
    E[:P] = torch.where(done & ~bad, pos >> 3, err).to(torch.int32)
    return E


def _walk_units(L: int) -> int:
    """The host scanner's unit budget for one block."""
    return L + L // MAX_RUN + 2


# K6's launch (csrc/scan_walk.cu): threads per block and units a lane walks
# between refills (the kernel's kThreads and kUnitsPerRound; the forms of
# K6' walk as many: at cap 12, 4 beat 1, 2, 8 and the cap's own), the
# largest tile and the most bytes staged past one (a walk that reads
# further goes on from global memory).  On an NVIDIA H100, tiles sized to
# fill the card in one wave beat fixed ones of 512 to 4096 bytes on both
# main-path streams.
SCAN_THREADS = 256
SCAN_UNITS_PER_ROUND = 4
SCAN_TILE_MAX = 4096
SCAN_HALO_MAX = 2048
# The largest L the scan takes: a walk's bits from its tile's first byte
# then stay far inside the kernel's int32 positions.
SCAN_MAX_L = 1 << 20


def walk_span_bytes(L: int) -> int:
    """Bytes, from its start byte on, that one walk can read before it
    settles: the last of its L + L//15 + 2 headers starts at most
    (units - 1) * (8 + 15) bits in, and the two-byte window that reads it
    takes the byte after."""
    return ((_walk_units(L) - 1) * (8 + MAX_SIZE)) // 8 + 2


def capped_span_bytes(L: int, cap: int) -> int:
    """Bytes, from its start byte on, that a walk capped at ``cap`` units
    can read, and the header it would resume at: ceil((8 + 23 cap) / 8),
    no more than :func:`walk_span_bytes` (which ``cap=0`` means)."""
    span = walk_span_bytes(L)
    if cap <= 0:
        return span
    return min(span, -(-(8 + (8 + MAX_SIZE) * cap) // 8))


class ScanWalkPlan(NamedTuple):
    tile: int        # table entries (and walkers) per thread block
    halo: int        # bytes staged past the tile, a multiple of 16


def scan_walk_plan(P: int, L: int, sms: int, cap: int = 0) -> ScanWalkPlan:
    """How K6 (and the range form of K6', capped at ``cap`` units) cuts a
    P-byte stream on a card of ``sms`` multiprocessors: the kernel runs one
    block per tile of the (P + 2)-entry table.  Tiles fill the card in one
    wave of ``2048 // SCAN_THREADS`` blocks each, but are no smaller than
    ``SCAN_THREADS`` bytes (a walk per lane) nor larger than
    ``SCAN_TILE_MAX``.  Each tile is staged with a halo of
    ``capped_span_bytes(L, cap)`` rounded up to 16 bytes, at most
    ``SCAN_HALO_MAX``."""
    halo = min(_ceil16(capped_span_bytes(L, cap)), SCAN_HALO_MAX)
    wave = sms * (2048 // SCAN_THREADS)
    tile = min(SCAN_TILE_MAX,
               max(SCAN_THREADS, _ceil16(-(-(P + 2) // wave))))
    return ScanWalkPlan(tile, halo)


# The list form of K6' runs a persistent grid of at most
# SCAN_RESUME_EIGHTHS eighths of a wave.  On an NVIDIA H100, half a wave
# beat a quarter and a whole one on the two-sweep table's survivors at
# caps 8, 12 and 20 on both main-path streams (chip_smoke.py times all
# three each run).
SCAN_RESUME_EIGHTHS = 4


def scan_resume_blocks(M: int, sms: int) -> int:
    """Thread blocks of the list form of K6' for up to M walkers: enough
    for a walker a lane, at most ``SCAN_RESUME_EIGHTHS`` eighths of a wave
    (``2048 // SCAN_THREADS`` blocks an SM); the grid's warps stride over
    the list in chunks of 32."""
    wave = sms * (2048 // SCAN_THREADS)
    return max(1, min(-(-M // SCAN_THREADS),
                      wave * SCAN_RESUME_EIGHTHS // 8))


@functools.lru_cache(maxsize=None)
def _multiprocessors(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_stream(stream: torch.Tensor, n_bytes: int, L: int) -> None:
    _check(stream, "stream", torch.uint8, 1)
    P = stream.shape[0]
    if not 0 <= n_bytes <= P:
        raise ValueError(f"n_bytes must be in [0, {P}], got {n_bytes}")
    if P + 2 >= 1 << 31:
        raise ValueError(f"a {P}-byte stream overflows the int32 end table")
    if not 1 <= L <= SCAN_MAX_L:
        raise ValueError(f"L must be in [1, {SCAN_MAX_L}], got {L}")


def scan_walk(stream: torch.Tensor, n_bytes: int, L: int) -> torch.Tensor:
    """(P,) uint8 stream buffer -> (P + 2,) int32 end table E: E[q] is the
    end byte of the block that starts at byte q, or ERR = P + 1 where the
    host scanner would reject it; E[P] = E[P + 1] = ERR.  Walkers read no
    further than ``n_bytes`` (<= P), the stream's true length."""
    _check_stream(stream, n_bytes, L)
    if not _on_cuda(stream):
        return scan_walk_plain(stream, n_bytes, L)
    P = stream.shape[0]
    plan = scan_walk_plan(P, L, _multiprocessors(stream.device))
    E = torch.empty(P + 2, dtype=torch.int32, device=stream.device)
    _launch("jt_scan_walk", stream.device, stream.data_ptr(), P,
            8 * n_bytes, L, plan.tile, plan.halo, E.data_ptr())
    _count(scan_walk)
    return E


class ScanSurvivors(NamedTuple):
    """The walkers still live at the cap of the two-sweep table's first
    sweep: the first ``n`` entries (a count on the device) of each (P,)
    buffer, in no order."""
    q: torch.Tensor      # int64 start bytes
    c: torch.Tensor      # int32 bits consumed from the block's start
    w: torch.Tensor      # int32 coefficient index reached
    n: torch.Tensor      # (1,) int64


def scan_walk_resume_plain(stream: torch.Tensor, n_bytes: int, L: int,
                           q: torch.Tensor, steps: int, c0: torch.Tensor,
                           w0: torch.Tensor, n_live: torch.Tensor,
                           table=None):
    """Plain version of K6' (both forms): :func:`scan_walk_plain`'s step
    loop over M walkers that start ``c0`` bits into the block at byte
    ``q`` with index ``w0``, for at most ``steps`` units; walkers at index
    >= ``n_live`` do not walk.  With ``table``, writes the walkers' entries
    there as :func:`scan_walk_resume` does and returns it."""
    P = stream.shape[0]
    M = q.shape[0]
    dev = stream.device
    b = torch.cat([stream.to(torch.int64),
                   torch.zeros(2, dtype=torch.int64, device=dev)])
    w16 = (b[:-1] << 8) | b[1:]                   # (P + 1,), w16[P] = 0
    limit = 8 * n_bytes
    skip = torch.arange(M, device=dev) >= n_live.reshape(())
    # Past the count, q may be anything: those walkers start at byte 0.
    start = torch.where(skip, 0, q) * 8
    pos = start + c0.to(torch.int64)
    widx = w0.to(torch.int64)
    done = torch.zeros(M, dtype=torch.bool, device=dev)
    bad = torch.zeros(M, dtype=torch.bool, device=dev)
    for _ in range(steps):
        live = ~(done | bad | skip)
        if not bool(live.any()):
            break
        h = (w16[(pos >> 3).clamp(0, P)] >> (8 - (pos & 7))) & 0xFF
        run = h >> 4
        size = h & 0xF
        eob = h == 0
        chain = h == 0xF0
        code = size != 0
        new_bad = live & ((pos + 8 > limit) | (~code & ~eob & ~chain)
                          | (code & (pos + 8 + size > limit))
                          | (code & (widx + run >= L)))
        new_done = live & ~new_bad & eob
        step = live & ~new_bad & ~eob
        pos = torch.where(step, pos + torch.where(code, 8 + size, 8), pos)
        widx = torch.where(step, widx + torch.where(code, run + 1, MAX_RUN),
                           widx)
        done = done | new_done
        bad = bad | new_bad
    c = pos - start
    length = torch.where(done, (c + 15) >> 3, torch.where(bad, -1, -2))
    if table is not None:
        # Walkers past the count write ERR to table[P], which holds it.
        at = torch.where(skip, P, q)
        table[at] = torch.where(done & ~skip, at + length, P + 1).to(
            torch.int32)
        return table
    return (length.to(torch.int32), c.to(torch.int32), widx.to(torch.int32))


def scan_walk_resume(stream: torch.Tensor, n_bytes: int, L: int,
                     q: torch.Tensor, cap: int, c0=None, w0=None,
                     n_live=None, table=None):
    """K6's walkers capped and resumed (the two-sweep form's list form).

    Walker i walks the block that starts at byte ``q[i]`` (int64), already
    ``c0[i]`` bits into it with coefficient index ``w0[i]`` (int32; zero
    when None), for at most ``cap`` units (0: the host scanner's whole
    budget, L + L//15 + 2).  Returns three (M,) int32 tensors: the block's
    byte length (EOB padded to a byte of the block), or -1 where the host
    scanner rejects it, or -2 for a walker still live at the cap; the bits
    consumed from the block's start; the coefficient index reached.  Feed
    the last two back as ``c0`` / ``w0`` to resume.  ``n_live`` (one int64
    on the tensors' device, or None for all M) is how many of the walkers
    walk: the rest return (-2, c0, w0) at once, and the count is read on
    the device, so a caller never waits for it.  Lanes are refilled from
    the list, and each walker reads its headers through a bit buffer.

    With ``table``, a (P + 2,) int32 end table, it returns nothing per
    walker: it writes ``table[q[i]]`` = q[i] + length, or ERR = P + 1 where
    the block is rejected or the walker is still live at the cap (the
    caller gives it the rest of the unit budget), for the walkers that
    walk, and returns ``table``.  This is sweep 2 of the two-sweep end
    table, over :func:`scan_walk_capped`'s survivors."""
    _check_stream(stream, n_bytes, L)
    if cap < 0:
        raise ValueError(f"cap must be >= 0, got {cap}")
    steps = _walk_units(L) if cap == 0 else min(cap, _walk_units(L))
    _check(q, "q", torch.int64, 1)
    P, M = stream.shape[0], q.shape[0]
    for name, t in (("c0", c0), ("w0", w0)):
        if t is not None:
            _check(t, name, torch.int32, 1)
            if t.shape[0] != M:
                raise ValueError(f"{M} walkers but {t.shape[0]} {name}")
    if n_live is not None:
        _check(n_live, "n_live", torch.int64, n_live.dim())
        if n_live.numel() != 1:
            raise ValueError("n_live must hold one count")
    if table is not None:
        _check(table, "table", torch.int32, 1)
        if table.shape[0] != P + 2:
            raise ValueError(f"table must have {P + 2} entries, got "
                             f"{table.shape[0]}")
    given = [t for t in (c0, w0, n_live, table) if t is not None]
    if not _on_cuda(stream, q, *given):
        zero = torch.zeros(M, dtype=torch.int32, device=q.device)
        return scan_walk_resume_plain(
            stream, n_bytes, L, q, steps, zero if c0 is None else c0,
            zero if w0 is None else w0,
            torch.tensor(M) if n_live is None else n_live, table)
    out = (None,) * 3
    if table is None:
        out = tuple(torch.empty(M, dtype=torch.int32, device=q.device)
                    for _ in range(3))
    if M:
        _launch("jt_scan_walk_resume", stream.device, stream.data_ptr(), P,
                8 * n_bytes, L, q.data_ptr(),
                *(None if t is None else t.data_ptr() for t in (c0, w0)), M,
                None if n_live is None else n_live.data_ptr(), steps,
                scan_resume_blocks(M, _multiprocessors(q.device)),
                None if table is None else table.data_ptr(),
                *(None if t is None else t.data_ptr() for t in out))
        _count(scan_walk_resume)
    return out if table is None else table


def scan_walk_capped_plain(stream: torch.Tensor, n_bytes: int, L: int,
                           cap: int):
    """Plain version of :func:`scan_walk_capped`: the list form's step loop
    over every byte, then the live walkers gathered in byte order."""
    P, dev = stream.shape[0], stream.device
    cap = min(cap, _walk_units(L))
    q = torch.arange(P, dtype=torch.int64, device=dev)
    zero = torch.zeros(P, dtype=torch.int32, device=dev)
    length, c, w = scan_walk_resume_plain(stream, n_bytes, L, q, cap, zero,
                                          zero, torch.tensor(P))
    E = torch.full((P + 2,), P + 1, dtype=torch.int32, device=dev)
    E[:P] = torch.where(length >= 0, q + length, P + 1).to(torch.int32)
    if cap == _walk_units(L):
        return E, None
    live = torch.nonzero(length == -2).reshape(-1)
    k = live.shape[0]
    surv = ScanSurvivors(torch.zeros(P, dtype=torch.int64, device=dev),
                         *(torch.zeros(P, dtype=torch.int32, device=dev)
                           for _ in range(2)),
                         torch.full((1,), k, dtype=torch.int64, device=dev))
    surv.q[:k] = live
    surv.c[:k] = c[live]
    surv.w[:k] = w[live]
    return E, surv


def scan_walk_capped(stream: torch.Tensor, n_bytes: int, L: int, cap: int):
    """Sweep 1 of the two-sweep end table (the range form of K6'): every
    byte's walker for at most ``cap`` (>= 1) units, from its block's start,
    on K6's staged tiles (:func:`scan_walk_plan` with the cap's halo).

    Returns the (P + 2,) int32 end table, with ERR = P + 1 where a walker
    is still live at the cap, and the :class:`ScanSurvivors` that are: one
    launch (and a memset of the count), nothing read back.  Where ``cap``
    covers the host scanner's unit budget there is no sweep 2: a live
    walker is ERR, and the survivors are None."""
    _check_stream(stream, n_bytes, L)
    if cap < 1:
        raise ValueError(f"cap must be >= 1, got {cap}")
    if not _on_cuda(stream):
        return scan_walk_capped_plain(stream, n_bytes, L, cap)
    P, dev = stream.shape[0], stream.device
    cap = min(cap, _walk_units(L))
    plan = scan_walk_plan(P, L, _multiprocessors(dev), cap)
    E = torch.empty(P + 2, dtype=torch.int32, device=dev)
    surv = None
    if cap < _walk_units(L):
        surv = ScanSurvivors(
            torch.empty(P, dtype=torch.int64, device=dev),
            *(torch.empty(P, dtype=torch.int32, device=dev)
              for _ in range(2)),
            torch.empty(1, dtype=torch.int64, device=dev))
    _launch("jt_scan_walk_capped", dev, stream.data_ptr(), P, 8 * n_bytes, L,
            cap, plan.tile, plan.halo, E.data_ptr(),
            *((None,) * 4 if surv is None else (t.data_ptr() for t in surv)))
    _count(scan_walk_capped)
    return E, surv


# ---------------------------------------------------------------------------
# K7, K8: end table -> orbit starts + end check (csrc/chase.cu)
# ---------------------------------------------------------------------------

def chase_starts_multi_plain(E: torch.Tensor, targets: torch.Tensor,
                             s0s: torch.Tensor, nb: int):
    """Plain version of K7 and K8: pointer doubling (``jpeg_tpu``'s
    ``device_scan`` ``T <- T[T]`` orbit fill).  Round r gathers starts
    [2^r, 2^(r+1)) through the table squared r times, so nb starts take
    ceil(log2(nb + 1)) gather rounds over E.  Returns ((B, nb) int64
    starts, (B,) bool ok)."""
    P2 = E.shape[0]
    B = targets.shape[0]
    dev = E.device
    if nb == 0:
        return (torch.zeros((B, 0), dtype=torch.int64, device=dev),
                s0s == targets)
    rounds = max(1, nb.bit_length())              # ceil(log2(nb + 1))
    orbit = torch.zeros((B, 1 << rounds), dtype=torch.int64, device=dev)
    orbit[:, 0] = s0s
    T = E.to(torch.int64)
    filled = 1
    for _ in range(rounds):
        orbit[:, filled:2 * filled] = T[orbit[:, :filled].clamp(0, P2 - 1)]
        if 2 * filled < orbit.shape[1]:             # the last square is unused
            T = T[T.clamp(0, P2 - 1)]
        filled *= 2
    starts = orbit[:, :nb].contiguous()
    end = E[starts[:, nb - 1].clamp(0, P2 - 1)].to(torch.int64)
    return starts, end == targets


def chase_starts_plain(E: torch.Tensor, target: int, s0: int, nb: int):
    """Plain version of K7 (one chain of :func:`chase_starts_multi_plain`)."""
    one = torch.ones(1, dtype=torch.int64, device=E.device)
    starts, ok = chase_starts_multi_plain(E, one * target, one * s0, nb)
    return starts[0], ok[0]


# The chase kernels index E in int32 and step a window past the last entry.
_CHASE_MAX_ENTRIES = (1 << 31) - (1 << 14)


def _check_chase(E: torch.Tensor, nb: int) -> None:
    _check(E, "E", torch.int32, 1)
    if not 1 <= E.shape[0] < _CHASE_MAX_ENTRIES:
        raise ValueError(f"the end table needs 1 to {_CHASE_MAX_ENTRIES - 1} "
                         f"entries, got {E.shape[0]}")
    if not 0 <= nb < 1 << 31:
        raise ValueError(f"nb must be in [0, 2**31), got {nb}")


# K7 / K8's jump k, the starts between two anchors of the long form
# (csrc/chase.cu's kJump): 16 beat 8, 32 and 64 on the 2048x2048 and
# 3840x2160 main-path streams on an NVIDIA H100.  Chains of at most
# CHASE_DIRECT_MAX starts take the short form, one launch that follows E
# itself: on that card it beat the long form's three launches up to 512
# starts a band, the two traded places between runs at 1,024, and the long
# form won from 2,048 on (chip_smoke.py phase 5 times both around the
# threshold).
CHASE_JUMP = 16
CHASE_DIRECT_MAX = 1024


class ChasePlan(NamedTuple):
    anchors: int         # anchors per band, ceil(nb / k); 0: the short form
    table_entries: int   # int32 scratch for the jump table (0: none)
    anchor_entries: int  # int32 scratch for the anchors (0: none)


def chase_plan(P2: int, B: int, nb: int) -> ChasePlan:
    """How K7 / K8 chase B bands of nb starts over a P2-entry table.  Up
    to ``CHASE_DIRECT_MAX`` starts: the short form, one block per band
    following E, with no scratch.  Longer: a jump table of E^k over all P2
    entries (k = ``CHASE_JUMP``), ceil(nb / k) - 1 serial jump steps per
    band, then one thread per anchor fills up to k starts."""
    if nb <= CHASE_DIRECT_MAX:
        return ChasePlan(0, 0, 0)
    anchors = -(-nb // CHASE_JUMP)
    return ChasePlan(anchors, P2, B * anchors)


def _chase(E: torch.Tensor, nb: int, targets, s0s, plan: ChasePlan):
    """Launch K7 / K8 on E's device with the wrapper's plan: ``targets``
    and ``s0s`` are (B,) int64 tensors (K8) or ints (K7, one band).
    Returns ((B, nb) int64 starts, (B,) bool ok); the wrappers count the
    launch."""
    multi = isinstance(targets, torch.Tensor)
    B = targets.shape[0] if multi else 1
    P2 = E.shape[0]
    dev = E.device
    starts = torch.empty((B, nb), dtype=torch.int64, device=dev)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    scratch = [torch.empty(n, dtype=torch.int32, device=dev) if n else None
               for n in (plan.table_entries, plan.anchor_entries)]
    args = (nb, *(None if t is None else t.data_ptr() for t in scratch),
            starts.data_ptr(), ok.data_ptr())
    if multi:
        _launch("jt_chase_multi", dev, E.data_ptr(), P2, targets.data_ptr(),
                s0s.data_ptr(), B, *args)
    else:
        _launch("jt_chase", dev, E.data_ptr(), P2, targets, s0s, *args)
    return starts, ok


def chase_starts(E: torch.Tensor, target: int, s0: int, nb: int):
    """(P2,) int32 end table -> ((nb,) int64 starts, 0-d bool ok): the
    chain s0, E[s0], E[E[s0]], ... and whether its end, one step past the
    last start, equals ``target``.  Positions are clamped to [0, P2 - 1]
    before they index E, whose entries must lie in that range (K6's do)."""
    _check_chase(E, nb)
    if not _on_cuda(E):
        return chase_starts_plain(E, target, s0, nb)
    starts, ok = _chase(E, nb, target, s0, chase_plan(E.shape[0], 1, nb))
    _count(chase_starts)
    return starts.reshape(nb), ok.reshape(())


def chase_starts_multi(E: torch.Tensor, targets: torch.Tensor,
                       s0s: torch.Tensor, nb: int):
    """(P2,) int32 end table + (B,) int64 targets and chain starts ->
    ((B, nb) int64 starts, (B,) bool ok): B chains of :func:`chase_starts`
    in one launch, one per band of a container."""
    _check_chase(E, nb)
    _check(targets, "targets", torch.int64, 1)
    _check(s0s, "s0s", torch.int64, 1)
    B = targets.shape[0]
    if s0s.shape[0] != B:
        raise ValueError(f"{B} targets but {s0s.shape[0]} chain starts")
    if not _on_cuda(E, targets, s0s):
        return chase_starts_multi_plain(E, targets, s0s, nb)
    if not B:
        return (torch.empty((0, nb), dtype=torch.int64, device=E.device),
                torch.empty(0, dtype=torch.bool, device=E.device))
    starts, ok = _chase(E, nb, targets, s0s, chase_plan(E.shape[0], B, nb))
    _count(chase_starts_multi)
    return starts, ok


# ---------------------------------------------------------------------------
# K10: stream bytes -> long bands' block starts + check (csrc/segment_scan.cu)
# ---------------------------------------------------------------------------

# K10 cuts each band into segments of SEGMENT_BYTES bytes, a walker each
# (a multiple of 32: a segment's bitmap is whole words).  A thread block of
# SEGMENT_THREADS walkers (the kernel's kThreads) stages its segments and
# a halo of the longest walk (walk_span_bytes, at most SCAN_HALO_MAX) in
# shared memory; each band's walkers take a multiple of SEGMENT_THREADS
# slots of scratch.  A stitch keeps its first SEGMENT_KEPT starts (kCont).
# The kernels run for at most SEGMENT_MAX_BANDS bands at a time (kMaxBands:
# the bands' offsets are launch arguments).  On an NVIDIA H100, segments of
# 128 bytes beat 256 and 512 on streams of 77 KB to 12 MB (more walkers to
# fill the card) and lost to 256 by 0.03 ms a call on a 47 MB stream, out
# of a 7.9 ms decode (benchmarks/torch_segment_scan.py; PERF.md).
SEGMENT_BYTES = 128
SEGMENT_THREADS = 128
SEGMENT_KEPT = 4
SEGMENT_MAX_BANDS = 16


def segment_counts(firsts, ends, seg_bytes: int) -> list:
    """Segments of each band [firsts[b], ends[b]): ceil(length / S), and
    one for an empty band."""
    return [max(1, -(-(e - f) // seg_bytes)) for f, e in zip(firsts, ends)]


def segment_scratch(counts, seg_bytes: int) -> tuple:
    """(walker slots, int32 scratch entries) of K10 for bands of ``counts``
    segments: each band's slots rounded up to SEGMENT_THREADS; a slot
    takes 13 entries, SEGMENT_KEPT kept starts and its bitmap, a warp of
    slots two entries, a band one (csrc/segment_scan.cu ``Segs``)."""
    G = sum(-(-K // SEGMENT_THREADS) * SEGMENT_THREADS for K in counts)
    per_slot = 13 + SEGMENT_KEPT + seg_bytes // 32
    return G, G * per_slot + G // 16 + len(counts)


def _band_step(buf: bytes, p: int, end: int, L: int):
    """One step of a band's walk from byte p < end, as K10's ``step()``:
    (the end of the block at p, True) where the host scanner's rules,
    reading no bit at or past ``end``, accept it, else (p + 1, False).
    ``buf`` has a zero byte past the stream."""
    limit = 8 * (end - p)
    pos = widx = 0
    base = 8 * p
    for _ in range(_walk_units(L)):
        if pos + 8 > limit:
            return p + 1, False
        bit = base + pos
        b = bit >> 3
        h = (((buf[b] << 8) | buf[b + 1]) >> (8 - (bit & 7))) & 0xFF
        if h == 0:
            return p + ((pos + 15) >> 3), True
        if h == 0xF0:
            widx += MAX_RUN
            pos += 8
            continue
        run, size = h >> 4, h & 0xF
        if size == 0 or pos + 8 + size > limit or widx + run >= L:
            return p + 1, False
        widx += run + 1
        pos += 8 + size
    return p + 1, False


def segment_scan_plain(stream: torch.Tensor, firsts, ends, nb: int, L: int,
                       seg_bytes: int):
    """Plain version of K10: its four phases in Python loops, a walker at a
    time, with a set of positions in place of each segment's bitmap.  It
    returns what the kernel returns, bit for bit: the starts of failed
    bands and the count of unsynced walkers too."""
    buf = bytes(stream.cpu().numpy().tobytes()) + b"\0"
    S = seg_bytes
    out = []
    faults_all = unsynced = 0
    for first, end, K in zip(firsts, ends, segment_counts(firsts, ends, S)):
        # 1. Walk: each segment's accepted positions, stop, last rejection.
        acc, stop, last_rej = [], [], []
        for k in range(K):
            p = first + k * S
            seg_end = min(p + S, end)
            got, rej = [], -1
            while p < seg_end:
                q, ok = _band_step(buf, p, end, L)
                if ok:
                    got.append(p)
                else:
                    rej = p
                p = q
            acc.append(got)
            stop.append(p)
            last_rej.append(rej)
        held = [set(a) for a in acc]
        # 2. Stitch: each walker on to a later walker's accepted position.
        link, entry, cont, bad = [], [], [], []
        for k in range(K):
            p, m, way, rej = stop[k], K, [], False
            if k + 1 < K:
                while p < end:
                    mm = (p - first) // S
                    if p in held[mm]:
                        m = mm
                        break
                    q, ok = _band_step(buf, p, end, L)
                    if ok:
                        way.append(p)
                    else:
                        rej = True
                    p = q
            if m < K:
                rej = rej or last_rej[m] >= p
            unsynced += m != k + 1
            link.append(m)
            entry.append(p)
            cont.append(way)
            bad.append(rej)
        # 3 and 4. The exact walk: segment 0, then each link from its entry;
        # its faults: a rejection in segment 0 or met on the way, a count
        # other than nb.
        walk, faults = [], int(last_rej[0] >= first)
        k, e = 0, first
        while k < K:
            walk += [x for x in acc[k] if x >= e] + cont[k]
            faults += bad[k]
            k, e = link[k], entry[k]
        faults += len(walk) != nb
        faults_all += faults
        out += walk[:nb] + [end] * (nb - len(walk))
    return (torch.tensor(out, dtype=torch.int64, device=stream.device),
            torch.tensor([faults_all, unsynced], dtype=torch.int32,
                         device=stream.device))


def segment_scan(stream: torch.Tensor, firsts, ends, nb: int, L: int,
                 seg_bytes: int = SEGMENT_BYTES):
    """(P,) uint8 stream buffer holding B bands, band b at bytes
    [firsts[b], ends[b]) (Python ints: they go to the kernel as launch
    arguments), nb blocks each -> ((B * nb,) int64 starts, (2,) int32
    status), with no end table and no host wait.

    Band b's starts are its exact walk's first nb accepted blocks, each
    walked with the host scanner's rules reading no bit past ends[b].
    ``status[0]`` is zero exactly when every band passes: its walk rejects
    no block and accepts nb (it counts the faults found).  A band passes
    exactly when :func:`chase_starts_multi` over :func:`scan_walk`'s table
    accepts it, and then the starts are the same.  A failed band's starts
    are positions of its walk, then ``ends[b]``.  ``status[1]`` counts the
    segments whose walker met no walk of the next segment
    (csrc/segment_scan.cu).  ``seg_bytes`` is a multiple of 32."""
    _check(stream, "stream", torch.uint8, 1)
    P = stream.shape[0]
    firsts, ends = [int(f) for f in firsts], [int(e) for e in ends]
    if len(firsts) != len(ends):
        raise ValueError(f"{len(firsts)} band starts but {len(ends)} ends")
    if not all(0 <= f <= e <= P for f, e in zip(firsts, ends)):
        raise ValueError(f"bands must lie in the {P}-byte stream")
    if P + 2 >= 1 << 31:
        raise ValueError(f"a {P}-byte stream overflows int32 positions")
    if not 1 <= L <= SCAN_MAX_L:
        raise ValueError(f"L must be in [1, {SCAN_MAX_L}], got {L}")
    if not 0 <= nb < 1 << 31:
        raise ValueError(f"nb must be in [0, 2**31), got {nb}")
    if seg_bytes < 32 or seg_bytes % 32:
        raise ValueError(f"seg_bytes must be a positive multiple of 32, got "
                         f"{seg_bytes}")
    if not _on_cuda(stream):
        return segment_scan_plain(stream, firsts, ends, nb, L, seg_bytes)
    dev, B = stream.device, len(firsts)
    starts = torch.empty(B * nb, dtype=torch.int64, device=dev)
    status = torch.empty(2, dtype=torch.int32, device=dev)
    if not B:
        return starts, status.zero_()
    G, entries = segment_scratch(segment_counts(firsts, ends, seg_bytes),
                                 seg_bytes)
    scratch = torch.empty(entries, dtype=torch.int32, device=dev)
    halo = min(_ceil16(walk_span_bytes(L)), SCAN_HALO_MAX)
    _launch("jt_segment_scan", dev, stream.data_ptr(), P,
            (ctypes.c_int64 * B)(*firsts), (ctypes.c_int64 * B)(*ends), B,
            seg_bytes, halo, L, nb, scratch.data_ptr(), G, starts.data_ptr(),
            status.data_ptr())
    _count(segment_scan)
    return starts, status


KERNELS = (encode_stream_rows, encode_stream_rows_tables, deposit_rows,
           decode_stream_blocks, decode_blocks, encode_blocks, scan_walk,
           scan_walk_capped, scan_walk_resume, chase_starts,
           chase_starts_multi, segment_scan)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launch_counts()
