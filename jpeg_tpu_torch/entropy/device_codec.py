"""Device entropy coding: levels <-> band bitstreams on the GPU.

Counterpart of ``jpeg_tpu/entropy/device_codec.py`` for the main path.

Encode, in two phases as in the JAX package:

1. :func:`block_bytes_of` computes every block's stream length from the
   levels alone (plain tensor code: runs, sizes, chain counts).  The host
   pulls a few scalars of it (longest block, total, band lengths, max
   |level|) to size phase 2 and to reject unrepresentable amplitudes.
2. :func:`encode_stream_sized`: kernel K1 (:func:`encode_rows`) writes each
   block's bytes as a row of big-endian words, and kernel K2
   (:func:`compact_rows`) deposits every row at its byte offset, giving the
   contiguous stream.  With ``enc="tables"`` the rows come from the
   unit-group tables (:func:`_unit_groups`) through kernel K9 instead, as
   the JAX package's tables path does.  Its overflow check raises on the host
   (:func:`check_sized_ok`), as the JAX package's poison flag does.

Decode: the block boundaries come from the host scan
(``entropy.scan_offsets``, C++) or the device scan (:mod:`.device_scan`,
kernels K6-K8), and kernel K3 (:func:`decode_stream`) decodes every block
from the uploaded stream (:func:`upload_stream`) at its start.

Bit and byte positions are int64 throughout.  The JAX package's int32
bit-position cap and self-chunking (``_CAP_BITS``, ``max_chunk_blocks``,
``encode_stream_chunks``) exist because the TPU has no int64, and are not
carried over; nor are the TPU compaction's merge depth, gather groups and
shape buckets, or the decode overlap table (with ``max_block_bytes_of``,
which sized it) and length sort.
"""
from __future__ import annotations

import warnings

import torch

from ..ops import kernels as K

MAX_RUN = 15
MAX_SIZE = 15


def _geometry(levels: torch.Tensor):
    """Per-slot code geometry for (N, L) int32 levels: (nz, absamp, size,
    nchains, rrem, group_bits), zero slots reporting size 0 and 0 bits."""
    nz = levels != 0
    absamp = levels.abs()
    # size = min(bit_length + 1, 15); frexp's exponent is the bit length
    # (exact: |a| < 2**24 converts to f32 exactly, larger values clamp).
    bitlen = torch.frexp(absamp.to(torch.float32))[1].to(torch.int32)
    size = torch.where(nz, (bitlen + 1).clamp(max=MAX_SIZE), 0)
    L = levels.shape[-1]
    idx = torch.arange(L, dtype=torch.int32, device=levels.device)
    marked = torch.where(nz, idx, -1)
    pmax = torch.cummax(marked, dim=-1).values
    prev = torch.cat([torch.full_like(pmax[..., :1], -1), pmax[..., :-1]],
                     dim=-1)
    run = idx - prev - 1
    nchains = torch.div(run, MAX_RUN, rounding_mode="floor")
    rrem = run - nchains * MAX_RUN
    group_bits = torch.where(nz, 8 * nchains + 8 + size, 0)
    return nz, absamp, size, nchains, rrem, group_bits


def block_bytes_of(levels: torch.Tensor) -> torch.Tensor:
    """(N, L) int32 levels -> (N,) int32 stream bytes per block (+ EOB,
    padded to a byte)."""
    group_bits = _geometry(levels)[-1]
    blk_bits = group_bits.sum(dim=-1) + 8
    return ((blk_bits + 7) >> 3).to(torch.int32)


ENCS = ("lv", "tables")

# A table group is 64 bits: 8 chain bytes of 0xF0 per 15 zeros + the code's
# 8 + 15 bits fit only while a run holds at most 4 chains, which any L <= 75
# guarantees (a run is at most L - 1 zeros).
TABLES_MAX_L = 75


def check_enc(enc: str, L: int) -> None:
    """Raise for an unknown ``enc`` or for ``"tables"`` at L > 75."""
    if enc not in ENCS:
        raise ValueError(f"enc must be one of {ENCS}, got {enc!r}")
    if enc == "tables" and L > TABLES_MAX_L:
        raise ValueError(
            f"tables encode path cannot carry L={L} zero-run chains; "
            "use the lv kernel (enc='lv')")


def _unit_groups(levels: torch.Tensor):
    """(N, L) int32 levels -> per-slot unit-group tables for kernel K9
    (``ops/kernels.py:encode_stream_rows_tables``).

    Returns ``(cbits, vhi, vlo, blk_bytes)``: slot s of block i appends
    ``cbits[i, s]`` bits of ``(vhi << 32) | vlo`` (int32 bit patterns of
    uint32 words): the slot's zero-run chain bytes (0xF0 each) followed by
    its run|size|sign|magnitude code, at most 55 bits while the slot holds
    at most 4 chains (L <= 75).  Slot L is the EOB byte plus the pad to a
    byte (all zeros); zero slots inside a run have cbits = 0.  Computed in
    int64, with the JAX package's uint32 arithmetic (a chain count above 4
    gives its garbage bit for bit: ``encode_rows`` refuses such L)."""
    nz, absamp, size, nchains, rrem, group_bits = _geometry(levels)
    mask32 = (1 << 32) - 1
    sz = size.to(torch.int64)
    nch = nchains.to(torch.int64)
    sign = (levels > 0).to(torch.int64)
    code = ((rrem.to(torch.int64) << (4 + sz)) | (sz << sz)
            | (sign << (torch.where(nz, sz, 1) - 1))
            | absamp.to(torch.int64)) & mask32
    # nch bytes of 0xF0, right-justified: 0xF0F0F0F0 >> (32 - 8 nch); the
    # uint32 shift count 32 - 8 nch wraps above 4 chains and clamps to 31.
    k8 = 8 * nch
    sh = torch.where(k8 > 32, 31, (32 - k8).clamp(max=31))
    pk = torch.where(nch > 0, 0xF0F0F0F0 >> sh, 0)
    s = 8 + sz                                    # code bits, 9..23 when nz
    vlo = torch.where(nz, ((pk << s) | code) & mask32, 0)
    vhi = torch.where(nz, pk >> (32 - s), 0)
    sum_bits = group_bits.to(torch.int64).sum(dim=-1)
    pad = (-(sum_bits + 8)) & 7
    blk_bytes = ((sum_bits + 8 + pad) >> 3).to(torch.int32)
    zero = torch.zeros_like(vlo[:, :1])
    cbits = torch.cat([group_bits.to(torch.int32),
                       (8 + pad).to(torch.int32)[:, None]], dim=-1)
    vhi = K._to_i32_words(torch.cat([vhi, zero], dim=-1))
    vlo = K._to_i32_words(torch.cat([vlo, zero], dim=-1))
    return cbits, vhi, vlo, blk_bytes


def encode_rows(levels: torch.Tensor, W: int, enc: str = "lv"):
    """(N, L) int32 levels -> ((N, W) int32 stream-word rows, (N,) int32
    block bytes).  W must cover the longest block
    (``ceil(max(block_bytes_of(levels)) / 4)``; :func:`encode_stream_sized`
    checks it).

    ``enc="lv"`` runs kernel K1 on the levels; ``enc="tables"`` builds the
    unit-group tables (:func:`_unit_groups`, which also give the block
    bytes) and runs kernel K9 on them, for L <= 75 only.  The rows are the
    same."""
    check_enc(enc, levels.shape[-1])
    if enc == "lv":
        return K.encode_stream_rows(levels, W)
    cbits, vhi, vlo, blk_bytes = _unit_groups(levels)
    return K.encode_stream_rows_tables(cbits, vhi, vlo, W), blk_bytes


def compact_rows(rows: torch.Tensor, blk_bytes: torch.Tensor,
                 cap: int) -> torch.Tensor:
    """(N, W) stream-word rows + block bytes -> (cap,) uint8 contiguous
    stream through kernel K2 (the exclusive prefix sum of ``blk_bytes``
    places every block)."""
    return K.deposit_rows(rows, blk_bytes, cap)


def encode_stream_sized(levels: torch.Tensor, W: int, cap: int,
                        enc: str = "lv"):
    """(N, L) int32 levels -> (bytes (cap,) uint8, blk_bytes (N,) int32,
    overflowed 0-d bool tensor), with the row width W and the buffer cap
    sized from phase 1's stats, through :func:`encode_rows`' ``enc``.

    A block needing more than 4*W bytes, or a stream longer than ``cap``,
    would be truncated silently (the wire format has no redundancy to catch
    it), so both are tested against the byte counts K1 computed; on
    overflow the buffer is zeroed and the flag set, and the host raises
    through :func:`check_sized_ok`."""
    rows, blk_bytes = encode_rows(levels, W, enc)
    buf = compact_rows(rows, blk_bytes, cap)
    bad = (blk_bytes.max() > 4 * W) | (blk_bytes.to(torch.int64).sum() > cap)
    return buf.masked_fill(bad, 0), blk_bytes, bad


def check_sized_ok(bad) -> None:
    """Host-side check of :func:`encode_stream_sized`'s overflow flag."""
    if bool(bad):
        raise ValueError(
            "sized encode overflow: a block exceeded the row width or the "
            "stream exceeded the output cap; both must come from this "
            "band's own phase-1 stats (block_bytes_of)")


def upload_stream(data, dev: torch.device) -> torch.Tensor:
    """Stream bytes (``bytes``, or a ``memoryview`` of a container's bands)
    -> (len,) uint8 tensor on ``dev``, moved from the caller's memory in
    one copy with no host copy before it (on the CPU the tensor is a view
    of that memory, which nothing writes).  An empty stream gives an empty
    tensor, so the scanners, not the upload, report it."""
    if not data:
        return torch.empty(0, dtype=torch.uint8, device=dev)
    with warnings.catch_warnings():
        # A tensor over a read-only buffer (a caller's bytes) could write
        # to it, torch warns; this one is only read.
        warnings.filterwarnings("ignore", "The given buffer is not writable",
                                UserWarning)
        host = torch.frombuffer(data, dtype=torch.uint8)
    return host.to(dev)


def decode_stream(stream_u8: torch.Tensor, starts: torch.Tensor,
                  L: int) -> torch.Tensor:
    """(nbytes,) uint8 stream + (N,) int64 block starts -> (N, L) int32
    levels through kernel K3.  ``starts`` come from a boundary scan; a
    device scan's starts may be garbage (up to one past the end) until its
    check is read, and K3 reads zeros, not memory, past the stream."""
    return K.decode_stream_blocks(stream_u8, starts.to(torch.int64), L)
