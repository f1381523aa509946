"""Run one cell of BENCHMARK.json once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
also ``breakdown``, and last ``checks``, each number compared beside its
limit.  Everything else goes to standard error, whose last lines are those
numbers again.  The run fails, and prints no result, without as many CUDA
devices as the cell asks for, without jpeg_tpu_torch beside this folder,
or when jax, jaxlib, flax or jpeg_tpu was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# One process with few threads: the program's host work runs on its own
# threads, and no CPU operator of the timed path needs a library's pool.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
FORBIDDEN = {"jax", "jaxlib", "flax", "jpeg_tpu"}


def forbidden_loaded():
    """Top-level names of loaded modules that no run may load, compared
    whole (``jpeg_tpu_torch`` is not ``jpeg_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from port_bench import harness, manifest, program
    try:
        cell = manifest.find_cell(ROOT, args.workload)
    except KeyError as e:
        log(str(e))
        return 2
    program.import_program()       # fails where jpeg_tpu_torch is absent
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        return 1
    stdout, sys.stdout = sys.stdout, sys.stderr
    try:
        result = harness.execute(ROOT, args.workload, args.seed, args.seconds,
                                 bool(args.trace), "cuda", T_START)
    finally:
        sys.stdout = stdout
    bad = forbidden_loaded()
    if bad:
        log(f"forbidden modules loaded: {', '.join(bad)}")
        return 1
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
