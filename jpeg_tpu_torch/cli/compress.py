"""CLI: compress an image — drop-in for the reference's compress.py.

Counterpart of ``jpeg_tpu/cli/compress.py``: the same flags and defaults
(reference compress.py:24-62: block_size 4, dct_size 8, transform DCT,
quantization 'qtable', qkeep 2, qdivisor 40), ``--dtype`` and ``--mesh``,
plus ``--device``: ``cuda`` (the default) runs the hand-written kernels and
raises without a GPU, ``cpu`` their plain PyTorch versions.
"""
from __future__ import annotations

import argparse
from typing import Optional

from ..api import Jpeg
from ..config import Configuration, QuantizationMethod


def device_mesh(device):
    """The mesh ``--mesh`` runs on: every CUDA device for ``cuda``, else
    the one device named."""
    import torch
    from .. import parallel
    from ..utils.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.device(device).index is None:
        return parallel.make_mesh()
    return parallel.make_mesh(devices=[dev])


def compress(input_fname: str, output_fname: str, block_size: int = 4,
             dct_size: int = 8, transform: str = "DCT",
             quantization: Optional[QuantizationMethod] = None,
             dtype=None, mesh: bool = False, device="cuda") -> None:
    from PIL import Image
    im = Image.open(input_fname).convert("YCbCr")
    config = Configuration(width=im.width, height=im.height,
                           block_size=block_size, dct_size=dct_size,
                           transform=transform, quantization=quantization)
    if mesh:
        # Row-band tiling over the mesh's devices; identical bytes to the
        # single-device path (byte-aligned bitstream stitch).
        import numpy as np
        from .. import container, parallel
        from ..container import CompressedData
        m = device_mesh(device)
        arr = np.asarray(im)
        bands = [parallel.compress_plane(arr[:, :, i].astype(np.int32),
                                         config, m, dtype=dtype)
                 for i in range(3)]
        compressed = container.generate_data(config, CompressedData(*bands))
    else:
        compressed = Jpeg(config, dtype, device=device).compress(im)
    with open(output_fname, "wb") as f:
        f.write(compressed)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Given an image, compress it using JPEG algorithm")
    parser.add_argument("infile", type=str,
                        help="a path to the file to compress")
    parser.add_argument("outfile", type=str, help="a destination path")
    parser.add_argument("--block_size", action="store", type=int, default=4,
                        help="size of sub-sampling block")
    parser.add_argument("--dct_size", action="store", type=int, default=8,
                        help="size of block for DCT transform")
    parser.add_argument("--transform", action="store", type=str,
                        default="DCT",
                        help="type of discrete transform (DCT vs DFT)")
    parser.add_argument("--quantization", action="store", type=str,
                        default="qtable",
                        help="type of quantization to use: "
                             "one of none, discard, divide, qtable")
    parser.add_argument("--qkeep", action="store", type=int, default=2,
                        help="how many coefficients to keep along both axes "
                             "(quantization == 'discard')")
    parser.add_argument("--qdivisor", action="store", type=int, default=40,
                        help="integer used to divide coefficients by "
                             "(quantization == 'divide')")
    parser.add_argument("--dtype", action="store", type=str, default=None,
                        help="compute dtype override (float32/float64)")
    parser.add_argument("--mesh", action="store_true",
                        help="row-band-tile each band over all devices")
    add_device_flag(parser)
    return parser


def add_device_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", action="store", type=str, default="cuda",
                        help="'cuda' (default) runs the GPU kernels; 'cpu' "
                             "their plain PyTorch versions")


def quantization_from_args(args: argparse.Namespace):
    if args.quantization == "discard":
        return QuantizationMethod("discard", keep=args.qkeep)
    if args.quantization == "divide":
        return QuantizationMethod("divide", divisor=args.qdivisor)
    if args.quantization == "qtable":
        return QuantizationMethod("qtable")
    return None


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    compress(args.infile, args.outfile, block_size=args.block_size,
             dct_size=args.dct_size, transform=args.transform,
             quantization=quantization_from_args(args), dtype=args.dtype,
             mesh=args.mesh, device=args.device)


if __name__ == "__main__":
    main()
