"""CLI: decompress a file — drop-in for the reference's decompress.py.

Counterpart of ``jpeg_tpu/cli/decompress.py``, plus ``--device``."""
from __future__ import annotations

import argparse

from ..api import Jpeg
from .compress import add_device_flag


def decompress(input_path: str, output_path: str, dtype=None,
               device="cuda") -> None:
    with open(input_path, "rb") as f:
        bytestream = f.read()
    reconstructed = Jpeg.decompress(bytestream, dtype, device=device)
    reconstructed.convert("RGB").save(output_path)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Decompress a file produced by compress.py into an image")
    parser.add_argument("infile", type=str,
                        help="a path to the compressed file")
    parser.add_argument("outfile", type=str, help="a destination image path")
    parser.add_argument("--dtype", action="store", type=str, default=None,
                        help="compute dtype override (float32/float64)")
    add_device_flag(parser)
    args = parser.parse_args(argv)
    decompress(args.infile, args.outfile, dtype=args.dtype,
               device=args.device)


if __name__ == "__main__":
    main()
