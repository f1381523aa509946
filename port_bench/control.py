"""Readings that the limits of ``checks.py`` were set from, at a cell's own
size: the program's answers (the lower reading) and the control's (the
upper reading) to every input of the pool, judged as a run judges them.

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3 \
        [--side program,control] [--device cuda]

The control is the reference in the program's place, computed in TF32
(the nearest precision below the float32 the configurations state).  One
JSON line a seed and side.  The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(root, cell_name, seed, side, device):
    """{number: {"value", "limit"}} for every input of the seed's pool."""
    import torch
    from port_bench import checks, harness, manifest, program
    cell = manifest.find_cell(root, cell_name)
    codec = harness.codec_of(cell.config)
    traffic = cell.traffic
    kind = traffic["takes"]
    dev = torch.device(device)
    pool, _ = harness.make_pool(root, cell, codec, kind, seed,
                                int(traffic["pool"]), dev)
    if side == "control":
        answers = [checks.control_answer(codec, kind, item, dev)
                   for item in pool]
    else:
        call = harness.make_call(root, cell, program.import_program(), device)
        step = int(traffic.get("batch", 1))
        answers = []
        for k in range(0, len(pool), step):
            answers += call(pool[k:k + step])
    missing = len(pool) - len(answers)
    samples = {i: [a] for i, a in enumerate(answers)}
    return checks.judge(checks.Reference(codec, kind, pool, dev), samples,
                        missing)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--side", default="program,control")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        for side in args.side.split(","):
            t0 = time.perf_counter()
            got = readings(ROOT, args.workload, seed, side, args.device)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": side, "checks": got,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
