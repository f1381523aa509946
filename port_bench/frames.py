"""Synthetic frames with photographic statistics, made on the device from the
seed.

Copied from bench.py's ``synth_image`` (smooth structure, texture and mild
noise, so the entropy coder sees what it sees on photographs and not the
worst case of pure noise), rewritten in torch, seeded from ``--seed``, and
varied per frame: each frame draws its own phases and scales its
wavelengths by 0.85-1.15.  The amplitudes and the noise level are fixed,
so every seed gives frames of about the same coded size.
"""
from __future__ import annotations

import math

import torch


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def synth_frames(count: int, height: int, width: int, seed: int,
                 device) -> torch.Tensor:
    """(count, H, W, 3) uint8 frames on ``device``."""
    g = generator(seed, device)
    draw = torch.rand((count, 3, 6), generator=g, device=device,
                      dtype=torch.float64).tolist()
    y = torch.arange(height, device=device, dtype=torch.float32)[:, None]
    x = torch.arange(width, device=device, dtype=torch.float32)[None, :]
    out = torch.empty((count, height, width, 3), dtype=torch.uint8,
                      device=device)
    for i in range(count):
        noise = torch.randn((3, height, width), generator=g, device=device)
        for c in range(3):
            u = draw[i][c]
            fx = (17 + 6 * c) * (0.85 + 0.3 * u[0])
            fy = (23 - 4 * c) * (0.85 + 0.3 * u[1])
            fd = (9 + 2 * c) * (0.85 + 0.3 * u[2])
            plane = (128
                     + 70 * torch.sin(x / fx + 2 * math.pi * u[3])
                     * torch.cos(y / fy + 2 * math.pi * u[4])
                     + 30 * torch.sin((x + y) / fd + 2 * math.pi * u[5])
                     + 8 * noise[c])
            out[i, :, :, c] = plane.clamp(0, 255).to(torch.uint8)
    return out
