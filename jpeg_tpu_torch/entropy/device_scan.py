"""Device boundary scan: every block's start offset without the host scan.

Counterpart of ``jpeg_tpu/entropy/device_scan.py``.  Block b + 1 starts
where block b ends, which looks serial, but every block starts on a byte,
so the set of candidate starts is small enough to try them all:

1. **Speculative per-byte walk** (kernel K6, :func:`end_table`): for every
   byte q, a walker scans "the block that starts at q" with the host
   scanner's rules and records its end byte in ``E[q]``, or the absorbing
   ``ERR = P + 1`` for anything the host scanner rejects.
2. **Orbit chase** (kernels K7 / K8, :func:`orbit_starts`,
   :func:`scan_bands_starts`): the true starts are the orbit of the band's
   first byte under E, ``s_0, s_{b+1} = E[s_b]``.
3. **One-scalar check**: ERR absorbs, so the stream is well formed exactly
   when the chain's end, one step past the last start, is the band's end
   offset.  When it is, the starts are the host scanner's, walk for walk;
   when it is not, the caller runs the host scanner for its error
   (:func:`scan_offsets_hybrid`, :func:`raise_rejected`).

A decode whose bands hold ``SEGMENTED_MIN_BLOCKS`` blocks or more finds its
starts with no table at all (kernel K10, :func:`scan_bands_segmented`):
each band is cut into segments, a walker each walks its segment block after
block (stepping one byte on where a block is rejected), and each walker
walks on into the next segment until it meets a position that segment's
walker accepted; from there the two walks are one.  Segment 0's walk is
exact, so the band's starts are stitched from the walkers the exact walk
passes through, and its check is the same as K6 + K8's.

Not carried over from the JAX package: the quarter-octave padding of the
stream (it bounded XLA compile counts; here P is the stream's true length),
and the walker-window rungs (``_SPAN_RUNGS``, ``span_rungs``, the rung
cache), which trimmed the TPU's row funnel and sized its decode row
gather.  K3 and K6 read the stream at their own positions, so the port
runs the exact walk once.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..ops import kernels as K
from ..utils.device import resolve_device
from ..utils.profiling import count, recording
from . import numpy_codec
from .device_codec import upload_stream

# Stream bytes from which the auto policy scans on the device when the C++
# scanner is missing, so that the host alternative is the pure-Python
# scanner.  Measured by chip_smoke.py (phase 5) on an NVIDIA H100 80GB HBM3
# at 700.00 W: a device scan call (upload, K6, K7, pull) took 0.10-0.15 ms
# on a 1 KB stream against 0.26-0.39 ms for the pure-Python scanner, and
# won at every larger size measured.  PERF.md lists the times.
PY_SCAN_DEVICE_MIN_BYTES = 1 << 10

# Blocks a band from which a device decode takes the segmented scan (K10)
# in place of K6's end table and K8's long form, which it replaces at every
# length: on an NVIDIA H100 80GB HBM3 a decode_to_device call with K10 beat
# the same call with K6 + K8 at every band measured, from 1,056 blocks
# (0.66 against 0.82 ms) to 375,000 (10.2 against 13.8 ms; PERF.md, runs of
# benchmarks/torch_segment_scan.py).  Shorter bands keep K8's short form,
# which takes less device time than K10 (0.057 against 0.067 ms a call at
# 920 blocks a band).
SEGMENTED_MIN_BLOCKS = K.CHASE_DIRECT_MAX + 1

SCANS = ("auto", "host", "device")


def end_table(stream: torch.Tensor, n_bytes: int, L: int,
              cap: int = 0) -> torch.Tensor:
    """(P,) uint8 stream buffer -> (P + 2,) int32 end table.

    ``E[q]`` is the end byte of the block that starts at byte q, or
    ``ERR = P + 1``; ``n_bytes`` is the stream's true length, where walkers
    stop.  ``cap=0`` (every caller's default) walks every byte in one sweep
    (kernel K6); ``cap > 0`` runs :func:`end_table_two_sweep`, which gives
    the same table."""
    if cap < 0:
        raise ValueError(f"cap must be >= 0, got {cap}")
    if cap == 0 or stream.shape[0] == 0:
        return K.scan_walk(stream, n_bytes, L)
    return end_table_two_sweep(stream, n_bytes, L, cap)


def end_table_two_sweep(stream: torch.Tensor, n_bytes: int, L: int,
                        cap: int) -> torch.Tensor:
    """:func:`end_table` in two sweeps (kernel K6' twice), for ``cap > 0``.

    Sweep 1 walks every byte for at most ``cap`` units, writes the table
    and appends the walkers still live to a survivor list on the device;
    sweep 2 resumes them for the rest of the host scanner's unit budget,
    reading their count from device memory, and writes their entries.  Two
    launches and a memset of the count, no glue between them, and the host
    never waits.  Where ``cap`` covers the budget, sweep 1 alone gives the
    table.  The table is the single sweep's, bit for bit."""
    budget = K._walk_units(L)
    E, surv = K.scan_walk_capped(stream, n_bytes, L, cap)
    if surv is not None:
        K.scan_walk_resume(stream, n_bytes, L, surv.q, budget - cap, surv.c,
                           surv.w, surv.n, table=E)
    return E


def orbit_starts(E: torch.Tensor, target: int, num_blocks: int,
                 s0: int = 0):
    """Orbit of ``s0`` under E (kernel K7): ((num_blocks,) int64 starts,
    0-d bool ok), ok when the orbit's end equals ``target``."""
    return K.chase_starts(E, target, s0, num_blocks)


def scan_table_and_starts(stream: torch.Tensor, n_bytes: int,
                          num_blocks: int, L: int):
    """One band: (stream buffer, true length) -> ((num_blocks,) int64
    starts, 0-d bool ok).  The starts mean something only when ok."""
    return orbit_starts(end_table(stream, n_bytes, L), n_bytes, num_blocks)


def scan_bands_starts(stream: torch.Tensor, ends, num_blocks: int, L: int,
                      firsts=None):
    """Several bands in ``stream``, in order: ONE end table over the buffer
    (K6), then one chase per band from its first byte (K8).

    Band b occupies bytes [firsts[b], ends[b]); without ``firsts`` the
    bands are back to back (band b starts at ``ends[b-1]``, the first at
    0), and with them bytes may lie between two bands (a container's
    length fields).  Every band has ``num_blocks`` blocks.  Returns
    ``((B * num_blocks,) int64 starts, 0-d bool ok)``, ok only when every
    band's chain ends exactly at its own end offset.  E[q] > q, so a band
    whose parse runs into the bytes after it overshoots its end and fails
    its check, and no chain starts between two bands."""
    ends = [int(e) for e in ends]
    firsts = [0] + ends[:-1] if firsts is None else [int(f) for f in firsts]
    E = end_table(stream, ends[-1], L)
    targets = torch.tensor(ends, dtype=torch.int64, device=stream.device)
    s0s = torch.tensor(firsts, dtype=torch.int64, device=stream.device)
    starts, oks = K.chase_starts_multi(E, targets, s0s, num_blocks)
    return starts.reshape(-1), oks.all()


def segmented(num_blocks: int) -> bool:
    """Whether a device decode with ``num_blocks`` blocks a band takes the
    segmented scan (:func:`scan_bands_segmented`) rather than K6 + K8
    (:func:`scan_bands_starts`)."""
    return num_blocks >= SEGMENTED_MIN_BLOCKS


def scan_bands_segmented(stream: torch.Tensor, ends, num_blocks: int,
                         L: int, firsts=None):
    """:func:`scan_bands_starts` without the end table (kernel K10): the
    same bands and starts, and a check that holds for the same streams.

    Returns ``((B * num_blocks,) int64 starts, (2,) int32 status)``:
    ``status[0]`` is zero where every band passes, ``status[1]`` counts
    the segments whose walker met no walk of the next one; read it with
    :func:`check_held`.  The bands' offsets go to the kernel as launch
    arguments, so nothing waits.  Counts ``scan.segments``, the walkers."""
    ends = [int(e) for e in ends]
    firsts = [0] + ends[:-1] if firsts is None else [int(f) for f in firsts]
    if recording():
        count("scan.segments", sum(K.segment_counts(firsts, ends,
                                                    K.SEGMENT_BYTES)))
    return K.segment_scan(stream, firsts, ends, num_blocks, L)


def check_held(ok: torch.Tensor) -> bool:
    """Read a device scan's check: :func:`scan_bands_starts`' 0-d bool, or
    :func:`scan_bands_segmented`'s status, which holds when it found no
    fault.  The status is read whole only while recording, where its
    unsynced walkers go to the counter ``scan.segments_unsynced``;
    otherwise one element comes back, as the bool does."""
    if ok.dim() == 0:
        return bool(ok)
    if not recording():
        return int(ok[0]) == 0
    faults, unsynced = ok.tolist()
    count("scan.segments_unsynced", unsynced)
    return faults == 0


def scan_mode(n_bytes: int = 1 << 30, scan: str = "auto",
              device="cuda") -> str:
    """Boundary-scan policy: ``"host"`` or ``"device"``.

    ``scan="host"`` / ``"device"`` choose; ``"auto"`` scans on the host
    whenever the C++ scanner exists, and always for ``device="cpu"`` (the
    plain versions are no faster than the host scanner).  Without the C++
    scanner the host alternative is the pure-Python scanner, and the device
    scan takes streams of ``PY_SCAN_DEVICE_MIN_BYTES`` and more."""
    if scan not in SCANS:
        raise ValueError(f"scan must be one of {SCANS}, got {scan!r}")
    if scan != "auto":
        return scan
    if torch.device(device).type != "cuda":
        return "host"
    from . import _get_native
    if _get_native() is not None:
        return "host"
    return "device" if n_bytes >= PY_SCAN_DEVICE_MIN_BYTES else "host"


def decode_scan(n_bytes: int, scan: str, dev: torch.device) -> str:
    """A decode's boundary scan, ``"host"`` or ``"device"``.

    It differs from :func:`scan_mode` because a decode keeps K3's starts on
    the device: on a CUDA device ``"auto"`` takes the device scan at every
    size, which won at every size measured, from 9 bytes of stream to
    664 KB, with or without the C++ scanner (PERF.md §6).  Otherwise it is
    :func:`scan_mode`'s rule, which ``entropy.scan_offsets`` keeps: its
    starts go back to the host."""
    if scan == "auto" and dev.type == "cuda":
        return "device"
    return scan_mode(n_bytes, scan, dev)


def raise_rejected(streams, num_blocks: int, L: int):
    """The device scan rejected ``streams`` (each band's bytes): the host
    scanner raises the stream's canonical error.  A stream the host scanner
    accepts means the device scan is wrong, and that raises too: a decode
    never moves to the host scan behind the caller's back."""
    for s in streams:
        _host_scan(s, num_blocks, L)
    raise RuntimeError("the device scan rejected a stream the host scanner "
                       "accepts (please report)")


def scan_offsets_device(data: bytes, num_blocks: int, L: int,
                        device="cuda"):
    """Run the device scan on one band's bytes.

    Returns ``(starts int32 ndarray, ok bool)``; the starts mean something
    only when ok.  The trivial cases are the host scanners'; everything
    else the kernels decide.  A stream shorter than ``num_blocks`` bytes
    (every block is at least one byte) fails before anything is sized from
    ``num_blocks`` or uploaded.  Does NOT raise on
    a malformed stream: :func:`scan_offsets_hybrid` reruns the host scanner
    for its error."""
    n = len(data)
    if num_blocks == 0:
        return np.zeros(0, np.int32), n == 0
    if n < num_blocks:
        return np.zeros(0, np.int32), False
    stream = upload_stream(data, resolve_device(device))
    starts, ok = scan_table_and_starts(stream, n, num_blocks, L)
    return starts.cpu().numpy().astype(np.int32), bool(ok)


def scan_offsets_hybrid(data: bytes, num_blocks: int, L: int,
                        device="cuda") -> np.ndarray:
    """Device scan with the host scanner behind it: the same result and the
    same errors as the host scanner.

    A valid stream gives the device's starts.  Anything malformed fails the
    device's single check, and the host scanner runs to raise its error."""
    starts, ok = scan_offsets_device(data, num_blocks, L, device)
    if ok:
        return starts
    host = _host_scan(data, num_blocks, L)             # expected to raise
    warnings.warn(
        "device scan rejected a stream the host scanner accepts; "
        "falling back to the host starts (please report)", RuntimeWarning,
        stacklevel=2)
    return host


def _host_scan(data: bytes, num_blocks: int, L: int) -> np.ndarray:
    """The host scanner: C++ when it built, else pure Python."""
    from . import _get_native
    nat = _get_native()
    if nat is not None:
        return nat.scan_offsets(data, num_blocks, L)
    return numpy_codec.scan_offsets(data, num_blocks, L)
