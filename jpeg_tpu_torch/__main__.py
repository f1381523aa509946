"""Unified CLI: ``python -m jpeg_tpu_torch {compress|decompress|batch} ...``
(counterpart of ``jpeg_tpu/__main__.py``)."""
from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    usage = "usage: python -m jpeg_tpu_torch {compress|decompress|batch} ..."
    if not argv:
        print(usage, file=sys.stderr)
        return 2
    if argv[0] in ("-h", "--help"):
        print(usage)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "compress":
        from .cli.compress import main as m
        return m(rest) or 0
    if cmd == "decompress":
        from .cli.decompress import main as m
        return m(rest) or 0
    if cmd == "batch":
        from .cli.batch import main as m
        return m(rest)
    print(f"unknown command {cmd!r}; expected compress/decompress/batch",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
