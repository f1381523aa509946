"""Plain PyTorch reference of the codec the benchmark measures.

Written from the upstream project's description of the format
(X-rayLaser/Implementing-JPEG-compression): each YCbCr band is edge-padded
to a multiple of the block size and mean-pooled over block_size x
block_size tiles, edge-padded to a multiple of the transform size, cut
into d x d blocks and transformed (the unnormalized DCT-II, or the real
part of the 2-D DFT), zigzag-ordered and quantized with round-half-even.
Each band is then run-length coded into a byte-aligned bit stream, and the
three streams go into one container behind a small header.  Decoding
inverts every step: dequantize, inverse transform, round, clamp to
[0, 255], inflate by block_size, crop.

It uses torch and the standard library only, and works on any device.
``precision="f64"`` is the reference itself.  ``precision="tf32"`` is the
control: the same products with both operands rounded to TF32 (10 stored
mantissa bits) and summed in float32, the precision a tensor-core product
gives when TF32 is switched on.

The f32 program is held to the f64 reference by the tie contract: levels
and pixels are equal, except that where the f64 value before rounding lies
within the f32 error bound of a .5 tie they may differ by exactly 1.  The
bound is (L + 16) 2^-23 times the sum of the absolute terms: the
contraction length L, plus 16 for the subsample's division and the
quantizer's epilogue.
"""
from __future__ import annotations

import dataclasses
import json
import math
import struct
from typing import Dict, List, Tuple

import torch

EPS32 = 2.0 ** -23
MAX_RUN = 15
MAX_SIZE = 15
MAX_AMP = (1 << (MAX_SIZE - 1)) - 1          # 16383: a size of 15 bits

#: The standard JPEG luminance table, which the upstream codec hard-codes
#: for ``qtable`` (8 x 8 only), row-major.
JPEG_QTABLE = (
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99)

#: The upstream defaults of the quantizers' parameters.
_QUANT_DEFAULTS = {"none": {}, "discard": {"keep": 2},
                   "divide": {"divisor": 40}, "qtable": {}}


class StreamError(ValueError):
    """A band stream or a container that does not decode."""


@dataclasses.dataclass(frozen=True)
class Codec:
    """One codec setting at one frame size; the geometry follows from it."""

    width: int
    height: int
    block_size: int
    dct_size: int
    transform: str = "DCT"
    quantization: str = "none"
    params: Tuple[Tuple[str, float], ...] = ()   # as given, in order

    @classmethod
    def from_settings(cls, settings: Dict, height: int, width: int):
        """From a configuration file's ``codec`` object."""
        quant = settings.get("quantization", {"name": "none"})
        codec = cls(width=int(width), height=int(height),
                    block_size=int(settings["block_size"]),
                    dct_size=int(settings["dct_size"]),
                    transform=settings.get("transform", "DCT"),
                    quantization=quant["name"],
                    params=tuple(quant.get("params", {}).items()))
        if codec.quantization not in _QUANT_DEFAULTS:
            raise ValueError(f"unknown quantization {codec.quantization!r}")
        if codec.transform not in ("DCT", "DFT"):
            raise ValueError(f"unknown transform {codec.transform!r}")
        if codec.quantization == "qtable" and codec.dct_size != 8:
            raise ValueError("the JPEG table is 8 x 8")
        return codec

    def param(self, key: str):
        return dict(self.params).get(key,
                                     _QUANT_DEFAULTS[self.quantization].get(key))

    @property
    def L(self) -> int:
        return self.dct_size ** 2

    @property
    def sub_height(self) -> int:
        return _ceil_to(self.height, self.block_size) // self.block_size

    @property
    def sub_width(self) -> int:
        return _ceil_to(self.width, self.block_size) // self.block_size

    @property
    def blocks_high(self) -> int:
        return _ceil_to(self.sub_height, self.dct_size) // self.dct_size

    @property
    def blocks_wide(self) -> int:
        return _ceil_to(self.sub_width, self.dct_size) // self.dct_size

    @property
    def num_blocks(self) -> int:
        return self.blocks_high * self.blocks_wide

    def quant_json(self) -> str:
        """The header's quantization JSON: the parameters as given, then
        the scheme's name (the upstream writer's order)."""
        d = dict(self.params)
        d["quantization_scheme_name"] = self.quantization
        return json.dumps(d)


def _ceil_to(n: int, f: int) -> int:
    return -(-int(n) // int(f)) * int(f)


# ---------------------------------------------------------------------------
# Operators (float64)
# ---------------------------------------------------------------------------

def zigzag_order(d: int) -> torch.Tensor:
    """Row-major indices of a d x d block in JPEG zigzag order: by
    anti-diagonal, even diagonals walked upwards (row falling), odd ones
    downwards."""
    cells = [(r, c) for r in range(d) for c in range(d)]
    cells.sort(key=lambda rc: (rc[0] + rc[1],
                               -rc[0] if (rc[0] + rc[1]) % 2 == 0 else rc[0]))
    return torch.tensor([r * d + c for r, c in cells], dtype=torch.int64)


def _dct(d: int) -> torch.Tensor:
    """The unnormalized DCT-II: A[k, n] = cos(pi / d * (n + 1/2) * k)."""
    k = torch.arange(d, dtype=torch.float64)[:, None]
    n = torch.arange(d, dtype=torch.float64)[None, :]
    return torch.cos(math.pi / d * (n + 0.5) * k)


def _dft_real(d: int, inverse: bool) -> torch.Tensor:
    """Real and imaginary parts of the DFT matrix (or of its inverse,
    conj(F) / d)."""
    j = torch.arange(d, dtype=torch.float64)
    ang = 2 * math.pi * torch.outer(j, j) / d
    if inverse:
        return torch.cos(ang) / d, torch.sin(ang) / d
    return torch.cos(ang), -torch.sin(ang)


def encode_operator(codec: Codec) -> torch.Tensor:
    """(L, L): zigzag coefficients = E @ row-major block pixels."""
    d = codec.dct_size
    if codec.transform == "DCT":
        a = _dct(d)
        full = torch.kron(a, a)
    else:                         # real part of kron(F, F)
        re, im = _dft_real(d, inverse=False)
        full = torch.kron(re, re) - torch.kron(im, im)
    return full[zigzag_order(d)]


def decode_operator(codec: Codec) -> torch.Tensor:
    """(L, L): row-major block pixels = W @ zigzag coefficients."""
    d = codec.dct_size
    if codec.transform == "DCT":
        a = _dct(d)
        b = a.T / (a * a).sum(dim=1)[None, :]       # A^-1 = A^T diag(1/|a_k|^2)
        full = torch.kron(b, b)
    else:
        re, im = _dft_real(d, inverse=True)
        full = torch.kron(re, re) - torch.kron(im, im)
    return full[:, zigzag_order(d)]


def epilogue(codec: Codec):
    """(mul, div, mask), float64 (L,) vectors: level = round(c * mul / div)
    * mask."""
    L, d = codec.L, codec.dct_size
    mul = torch.ones(L, dtype=torch.float64)
    div = torch.ones(L, dtype=torch.float64)
    mask = torch.ones(L, dtype=torch.float64)
    zz = zigzag_order(d)
    if codec.quantization == "qtable":
        mul = 1.0 / torch.tensor(JPEG_QTABLE, dtype=torch.float64)[zz]
    elif codec.quantization == "divide":
        div = div * float(codec.param("divisor"))
    elif codec.quantization == "discard":
        keep = int(codec.param("keep"))
        r = torch.arange(d)[:, None]
        c = torch.arange(d)[None, :]
        mask = ((r < keep) & (c < keep)).to(torch.float64).reshape(-1)[zz]
    return mul, div, mask


def dequantize(codec: Codec, levels: torch.Tensor) -> torch.Tensor:
    """Levels (..., L) -> float64 coefficients.  The upstream codec stores
    the restored values in its integer array, so a divisor that is not a
    whole number truncates."""
    lv = levels.to(torch.int64)
    if codec.quantization == "qtable":
        q = torch.tensor(JPEG_QTABLE, dtype=torch.int64)[
            zigzag_order(codec.dct_size)].to(lv.device)
        return (lv * q).to(torch.float64)
    if codec.quantization == "divide":
        dv = float(codec.param("divisor"))
        if dv == int(dv):
            return (lv * int(dv)).to(torch.float64)
        return torch.trunc(lv.to(torch.float64) * dv)
    return lv.to(torch.float64)


# ---------------------------------------------------------------------------
# Pixels <-> levels
# ---------------------------------------------------------------------------

def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 stored mantissa bits), to nearest
    with ties away from zero, as the tensor cores' conversion does."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & -0x2000
    return bits.view(torch.float32)


def _product(x: torch.Tensor, op_t: torch.Tensor, precision: str):
    """x @ op_t in the given precision."""
    if precision == "f64":
        return x.to(torch.float64) @ op_t.to(torch.float64)
    if precision == "tf32":
        return to_tf32(x) @ to_tf32(op_t)
    raise ValueError(f"unknown precision {precision!r}")


def _pad_edge(x: torch.Tensor, f: int) -> torch.Tensor:
    """Repeat the last row and column up to multiples of f."""
    h, w = x.shape[-2:]
    rows = torch.arange(_ceil_to(h, f), device=x.device).clamp(max=h - 1)
    cols = torch.arange(_ceil_to(w, f), device=x.device).clamp(max=w - 1)
    return x.index_select(-2, rows).index_select(-1, cols)


def _blocks(codec: Codec, frame: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8 frame -> (3, N, L) float64 row-major pixel blocks of
    the subsampled, padded bands."""
    if tuple(frame.shape) != (codec.height, codec.width, 3):
        raise ValueError(f"frame shape {tuple(frame.shape)} != "
                         f"({codec.height}, {codec.width}, 3)")
    bs, d = codec.block_size, codec.dct_size
    x = _pad_edge(frame.permute(2, 0, 1).to(torch.float64), bs)
    h, w = x.shape[-2:]
    total = x.reshape(3, h // bs, bs, w // bs, bs).sum(dim=(2, 4))
    sub = total / torch.full_like(total, bs * bs)
    sub = _pad_edge(sub, d)
    nv, nh = sub.shape[-2] // d, sub.shape[-1] // d
    return (sub.reshape(3, nv, d, nh, d).permute(0, 1, 3, 2, 4)
            .reshape(3, nv * nh, d * d))


def encode_levels(codec: Codec, frame: torch.Tensor, precision: str = "f64"):
    """(H, W, 3) uint8 frame -> ((3, N, L) int64 levels, (3, N, L) bool
    ties).  The ties are those of the f64 values, whatever the precision."""
    vec = _blocks(codec, frame)
    dev = vec.device
    enc = encode_operator(codec).to(dev)
    mul, div, mask = (v.to(dev) for v in epilogue(codec))
    c = _product(vec, enc.T, precision)
    q = c * mul.to(c.dtype) / div.to(c.dtype)
    levels = (torch.round(q) * mask.to(c.dtype)).to(torch.int64)
    exact = (vec @ enc.T) * mul / div if precision != "f64" else q
    bound = ((codec.L + 16) * EPS32
             * ((vec.abs() @ enc.abs().T) * mul.abs() / div))
    ties = ((exact - torch.floor(exact) - 0.5).abs() <= bound) & (mask != 0)
    return levels, ties


def decode_planes(codec: Codec, levels: torch.Tensor,
                  precision: str = "f64"):
    """(3, N, L) levels -> ((3, H, W) uint8 planes, (3, H, W) bool ties).
    The ties are those of the f64 values, whatever the precision."""
    dev = levels.device
    deq = dequantize(codec, levels)
    dec = decode_operator(codec).to(dev)
    v = _product(deq, dec.T, precision).to(torch.float64)
    exact = deq @ dec.T if precision != "f64" else v
    bound = (codec.L + 16) * EPS32 * (deq.abs() @ dec.abs().T)
    planes = _assemble(codec, torch.round(v).clamp(0, 255).to(torch.uint8))
    ties = _assemble(codec, (exact - torch.floor(exact) - 0.5).abs() <= bound)
    return planes, ties


def _assemble(codec: Codec, blk: torch.Tensor) -> torch.Tensor:
    """(3, N, L) per-block values -> (3, H, W): the blocks laid out, the
    transform padding cropped, inflated by block_size, cropped."""
    d, bs = codec.dct_size, codec.block_size
    nv, nh = codec.blocks_high, codec.blocks_wide
    plane = (blk.reshape(3, nv, nh, d, d).permute(0, 1, 3, 2, 4)
             .reshape(3, nv * d, nh * d)[:, :codec.sub_height,
                                          :codec.sub_width])
    plane = plane.repeat_interleave(bs, dim=1).repeat_interleave(bs, dim=2)
    return plane[:, :codec.height, :codec.width]


# ---------------------------------------------------------------------------
# Entropy coding
#
# Per block, in zigzag order: for each nonzero amplitude a after r zeros,
# r // 15 chain units (the byte 0xF0), then one code: r % 15 (4 bits),
# size = bit_length(|a|) + 1 (4 bits), a sign bit (1 = positive) and |a|
# in size - 1 bits, most significant first.  The block ends with 8 zero
# bits (end of block) and zero padding to the next byte, so every block
# starts on a byte.
# ---------------------------------------------------------------------------

def _bit_length(x: torch.Tensor) -> torch.Tensor:
    """Exact bit length of non-negative integers below 2^15."""
    powers = torch.tensor([1 << k for k in range(MAX_SIZE)],
                          dtype=torch.int64, device=x.device)
    return (x[:, None] >= powers[None, :]).sum(dim=1)


def entropy_encode(levels: torch.Tensor) -> bytes:
    """(N, L) integer levels -> the band's byte stream."""
    if levels.dim() != 2:
        raise ValueError(f"levels must be (N, L), got {tuple(levels.shape)}")
    lv = levels.to(torch.int64)
    n, L = lv.shape
    dev = lv.device
    nz = lv != 0
    bid, pos = nz.nonzero(as_tuple=True)          # block order, then index
    amp = lv[bid, pos]
    mag = amp.abs()
    if mag.numel() and int(mag.max()) > MAX_AMP:
        raise ValueError(f"amplitude {int(mag.max())} exceeds {MAX_AMP}")
    idx = torch.arange(L, device=dev)
    last = torch.where(nz, idx[None, :], torch.full_like(lv, -1))
    last = torch.cummax(last, dim=1).values
    prev = torch.cat([torch.full((n, 1), -1, dtype=torch.int64, device=dev),
                      last[:, :-1]], dim=1)
    run = (idx[None, :] - prev - 1)[bid, pos]
    size = _bit_length(mag) + 1
    chains = run // MAX_RUN
    code_bits = 8 + size
    group_bits = 8 * chains + code_bits
    blk_bits = torch.full((n,), 8, dtype=torch.int64, device=dev)
    blk_bits.index_add_(0, bid, group_bits)
    blk_bytes = (blk_bits + 7) // 8
    blk_start = torch.cumsum(blk_bytes, 0) - blk_bytes
    total = int(blk_bytes.sum())
    if amp.numel() == 0:
        return bytes(total)
    excl = torch.cumsum(group_bits, 0) - group_bits
    first = torch.searchsorted(bid, torch.arange(n, device=dev))
    base = excl[first.clamp(max=amp.numel() - 1)]
    start = blk_start[bid] * 8 + excl - base[bid]
    sign = (amp > 0).to(torch.int64)
    vals = (((run % MAX_RUN) << (4 + size)) | (size << size)
            | (sign << (size - 1)) | mag)
    # Units: every chain (8 bits of 0xF0), then every code.
    n_ch = int(chains.sum())
    ch_owner = torch.repeat_interleave(
        torch.arange(amp.numel(), device=dev), chains)
    ch_rank = (torch.arange(n_ch, device=dev)
               - (torch.cumsum(chains, 0) - chains)[ch_owner])
    u_start = torch.cat([start[ch_owner] + 8 * ch_rank, start + 8 * chains])
    u_len = torch.cat([torch.full((n_ch,), 8, dtype=torch.int64, device=dev),
                       code_bits])
    u_val = torch.cat([torch.full((n_ch,), 0xF0, dtype=torch.int64,
                                  device=dev), vals])
    within = (torch.arange(int(u_len.sum()), device=dev)
              - torch.repeat_interleave(torch.cumsum(u_len, 0) - u_len, u_len))
    bitpos = torch.repeat_interleave(u_start, u_len) + within
    shift = torch.repeat_interleave(u_len, u_len) - 1 - within
    bit = (torch.repeat_interleave(u_val, u_len) >> shift) & 1
    bits = torch.zeros(total * 8, dtype=torch.int64, device=dev)
    bits[bitpos] = bit
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int64,
                           device=dev)
    packed = (bits.reshape(total, 8) * weights).sum(dim=1).to(torch.uint8)
    return packed.cpu().numpy().tobytes()


def _windows(data: bytes, device) -> torch.Tensor:
    """For each byte offset b, the big-endian 32-bit word of bytes b .. b+3
    (zeros past the end), as int64."""
    raw = torch.frombuffer(bytearray(data + b"\x00" * 4), dtype=torch.uint8)
    raw = raw.to(device=device, dtype=torch.int64)
    n = len(data) + 1
    return ((raw[:n] << 24) | (raw[1:n + 1] << 16) | (raw[2:n + 2] << 8)
            | raw[3:n + 3])


def _walk(win: torch.Tensor, nbits: int, starts: torch.Tensor, L: int,
          out=None):
    """Walk one block from each byte offset in ``starts``, all in lockstep.
    Returns (end byte offset, ok) per walker; with ``out`` ((len(starts), L)
    int64), also writes each walker's amplitudes."""
    dev = starts.device
    nw = starts.numel()
    pos = starts * 8
    widx = torch.zeros(nw, dtype=torch.int64, device=dev)
    live = torch.ones(nw, dtype=torch.bool, device=dev)
    ok = torch.zeros(nw, dtype=torch.bool, device=dev)
    rows = torch.arange(nw, device=dev)

    def read(p, n):
        w = win[(p >> 3).clamp(max=win.numel() - 1)]
        return (w >> (32 - (p & 7) - n)) & ((1 << n) - 1)

    for _ in range(L + L // MAX_RUN + 2):
        if not bool(live.any()):
            break
        head = read(pos, 8)
        run, size = head >> 4, head & 15
        eob = live & (head == 0)
        chain = live & (run == MAX_RUN) & (size == 0)
        code = live & (size > 0)
        short = (pos + 8 + size) > nbits
        bad = live & (((size == 0) & (run != 0) & (run != MAX_RUN))
                      | ((eob | chain | code) & short))
        target = widx + run
        bad |= code & (target >= L)
        code &= ~bad
        if out is not None and bool(code.any()):
            word = read(pos + 8, 15)                     # sign + 14 bits
            sgn = (word >> (15 - 1)) & 1
            m = (word & ((1 << 14) - 1)) >> (15 - size)
            amp = torch.where(sgn == 1, m, -m)
            sel = rows[code]
            out[sel, target[code]] = amp[code]
        ok |= eob & ~bad
        widx = torch.where(chain & ~bad, widx + MAX_RUN,
                           torch.where(code, target + 1, widx))
        step = torch.where(eob, ((pos + 15) & ~7) - pos,
                           torch.where(chain, 8, 8 + size))
        pos = torch.where(live, pos + step, pos)
        live &= ~(eob | bad)
    return pos >> 3, ok


def entropy_decode(data: bytes, num_blocks: int, L: int,
                   device="cpu") -> torch.Tensor:
    """A band's byte stream -> (num_blocks, L) int64 levels.  Raises
    :class:`StreamError` unless the stream is exactly ``num_blocks`` valid
    blocks."""
    n = len(data)
    if n < num_blocks or (num_blocks == 0) != (n == 0):
        raise StreamError(f"{n} bytes cannot hold {num_blocks} blocks")
    if num_blocks == 0:
        return torch.zeros((0, L), dtype=torch.int64, device=device)
    win = _windows(data, device)
    # Where does a block that starts at each byte end?  Then follow the
    # chain from byte 0.
    every = torch.arange(n, device=device)
    ends, ok = _walk(win, 8 * n, every, L)
    ends, ok = ends.cpu().tolist(), ok.cpu().tolist()
    starts, s = [], 0
    for b in range(num_blocks):
        if s >= n or not ok[s]:
            raise StreamError(f"block {b} at byte {s} does not decode")
        starts.append(s)
        s = ends[s]
    if s != n:
        raise StreamError(f"{n - s} bytes after {num_blocks} blocks")
    out = torch.zeros((num_blocks, L), dtype=torch.int64, device=device)
    _walk(win, 8 * n, torch.tensor(starts, dtype=torch.int64, device=device),
          L, out)
    return out


# ---------------------------------------------------------------------------
# Container: u16 header length, u16 width, u16 height, u16 block size,
# u16 transform size, 3 ASCII bytes of the transform, u16 JSON length, the
# quantization JSON; then three times a u32 length and a band's bytes.
# Little-endian.
# ---------------------------------------------------------------------------

def pack_container(codec: Codec, bands: List[bytes]) -> bytes:
    qj = codec.quant_json().encode("ascii")
    head = (struct.pack("<HHHHH", 2 + 13 + len(qj), codec.width,
                        codec.height, codec.block_size, codec.dct_size)
            + codec.transform.encode("ascii") + struct.pack("<H", len(qj))
            + qj)
    return head + b"".join(struct.pack("<L", len(b)) + b for b in bands)


def read_container(blob: bytes):
    """-> (header fields, [y, cb, cr] band bytes).  Raises
    :class:`StreamError` on a short or inconsistent container."""
    try:
        hl, w, h, bs, d = struct.unpack_from("<HHHHH", blob, 0)
        transform = blob[10:13].decode("ascii")
        (ql,) = struct.unpack_from("<H", blob, 13)
        quant = json.loads(blob[15:15 + ql].decode("ascii"))
        pos, bands = hl, []
        for _ in range(3):
            (n,) = struct.unpack_from("<L", blob, pos)
            pos += 4
            if pos + n > len(blob):
                raise StreamError("band runs past the container")
            bands.append(bytes(blob[pos:pos + n]))
            pos += n
    except (struct.error, UnicodeDecodeError, json.JSONDecodeError) as e:
        raise StreamError(f"unreadable container: {e}") from e
    if pos != len(blob) or hl != 15 + ql:
        raise StreamError("container lengths do not add up")
    name = quant.pop("quantization_scheme_name", None)
    fields = {"width": w, "height": h, "block_size": bs, "dct_size": d,
              "transform": transform, "quantization": name,
              "params": quant}
    return fields, bands


def header_matches(codec: Codec, fields: Dict) -> bool:
    return fields == {"width": codec.width, "height": codec.height,
                      "block_size": codec.block_size,
                      "dct_size": codec.dct_size,
                      "transform": codec.transform,
                      "quantization": codec.quantization,
                      "params": dict(codec.params)}


def encode_container(codec: Codec, frame: torch.Tensor) -> bytes:
    """(H, W, 3) uint8 frame -> container bytes, from the f64 levels."""
    levels, _ = encode_levels(codec, frame)
    return pack_container(codec, [entropy_encode(b) for b in levels])


def decode_container_levels(codec: Codec, blob: bytes, device="cpu"):
    """Container bytes -> (3, N, L) int64 levels; raises
    :class:`StreamError` when the container is not this codec's."""
    fields, bands = read_container(blob)
    if not header_matches(codec, fields):
        raise StreamError(f"header {fields} is not the configuration's")
    return torch.stack([entropy_decode(b, codec.num_blocks, codec.L, device)
                        for b in bands])
