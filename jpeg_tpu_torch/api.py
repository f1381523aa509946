"""Public codec API: image compress/decompress on a GPU (or the CPU).

Counterpart of ``jpeg_tpu/api.py``'s main path: ``compress_ycbcr`` with
device entropy coding (the content-sized two-phase encode) and
``decompress_to_ycbcr`` with the host C++ boundary scan and device decode.
Containers are the same bytes as the JAX package's.  Every function takes an
explicit ``device``: ``"cuda"`` (the default) runs the hand-written kernels
and raises without a GPU; ``"cpu"`` runs their plain PyTorch versions.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import container, entropy
from .config import BadRleCodeError, Configuration
from .container import CompressedData
from .entropy import device_codec as DC
from .ops.band import BandDecoder, BandEncoder
from .utils.device import resolve_device


def compress_ycbcr(ycbcr: np.ndarray, config: Configuration,
                   device="cuda") -> bytes:
    """(H, W, 3) uint8 YCbCr image -> container bytes.

    All three bands (including luma) go through the same subsample path,
    matching the reference codec.  The encode runs in two phases: the
    coefficient transform and every block's stream length on ``device``,
    then one small pull of their stats (longest block, total, band lengths,
    max |level|) that rejects unrepresentable amplitudes BEFORE any entropy
    coding and sizes the rows and the buffer of phase 2 (kernels K1, K2)."""
    ycbcr = np.asarray(ycbcr)
    if ycbcr.ndim != 3 or ycbcr.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) YCbCr array, got {ycbcr.shape}")
    dev = resolve_device(device)
    img = torch.from_numpy(np.ascontiguousarray(ycbcr)).to(dev)
    levels = BandEncoder(config).to(dev)(img.permute(2, 0, 1))  # (3, N, L)
    flat = levels.reshape(-1, levels.shape[-1])
    bb = DC.block_bytes_of(flat).to(torch.int64)
    band_bytes = bb.reshape(3, -1).sum(dim=-1)
    stats = torch.stack([bb.max(), bb.sum(), band_bytes[0], band_bytes[1],
                         flat.abs().max().to(torch.int64)])
    max_bb, total, b0, b1, mx = (int(x) for x in stats.cpu())
    if mx > entropy.MAX_AMP:
        raise BadRleCodeError(
            f"amplitude {mx} exceeds the representable {entropy.MAX_AMP}")
    buf, _, bad = DC.encode_stream_sized(flat, -(-max_bb // 4), total)
    DC.check_sized_ok(bad.cpu())
    raw = buf.cpu().numpy().tobytes()
    bands = [raw[:b0], raw[b0:b0 + b1], raw[b0 + b1:total]]
    return container.generate_data(config, CompressedData(*bands))


def decompress_to_ycbcr(bytestream: bytes, device="cuda") -> np.ndarray:
    """Container bytes -> (H, W, 3) uint8 YCbCr image.

    The host does the serial O(bytes) boundary scan (C++, which also
    validates the stream); bit parsing, dequantize, IDCT and clamp run on
    ``device``."""
    config, data = container.read_data(bytestream)
    planes = _host_scan_decompress(config, [data.y, data.cb, data.cr],
                                   resolve_device(device))
    return planes.cpu().numpy().transpose(1, 2, 0)


def _host_scan_decompress(config: Configuration, streams,
                          dev: torch.device) -> torch.Tensor:
    """Host boundary scan + device decode; returns (3, H, W) uint8 planes
    on ``dev``."""
    nb, L = config.num_blocks, config.dct_size ** 2
    buf = b"".join(streams)
    # Start the stream upload, then scan the three bands on host threads
    # (the C++ scanner releases the GIL).
    stream = torch.frombuffer(bytearray(buf), dtype=torch.uint8).to(dev)
    with ThreadPoolExecutor(max_workers=3) as pool:
        scans = list(pool.map(
            lambda s: entropy.scan_offsets(s, nb, L), streams))
    starts, off = [], 0
    for s, sc in zip(streams, scans):
        starts.append(sc.astype(np.int64) + off)
        off += len(s)
    starts_t = torch.from_numpy(np.concatenate(starts)).to(dev)
    levels = DC.decode_stream(stream, starts_t, L)          # (3N, L)
    return BandDecoder(config).to(dev)(levels.reshape(3, nb, L))


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    """Peak signal-to-noise ratio between two images (dB)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))
