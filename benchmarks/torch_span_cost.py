#!/usr/bin/env python3
"""The cost of jpeg_tpu_torch's span recorder on one GPU: a benchmark
cell's call in one process, over windows that alternate between recording
on and off.

    python3 benchmarks/torch_span_cost.py --workload <cell> [--seed N] \
        [--windows 8] [--seconds 4]

The cell's configuration, traffic mix, pool and call come from
``port_bench`` (BENCHMARK.json), as an untraced run of the cell makes them;
every pool input is decoded once and the loop runs 2 s before the first
window.  Then ``2 * windows`` windows of ``seconds`` each run the closed
loop, recording off and on in the order off, on, on, off, off, on, ...
(``utils.profiling.start_recording`` / ``stop_recording`` between
windows, outside the timed calls).  Prints a line per window (its calls
and median call time), the median call time of every call with recording
on and with it off, and the per-answer means of each span and counter of
the windows with recording on; then the host time of one empty span
(enter and exit, median of 25 runs of 20,000) with recording off and on,
and of a ``count``; last, a JSON object of them with the card's ``name,
power.limit``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def span_ns(P, recording: bool, runs: int = 25, n: int = 20_000):
    """Median host time of one empty span, and of one ``count``, in ns."""
    def once(body) -> float:
        if recording:
            P.start_recording()
        t0 = time.perf_counter_ns()
        for _ in range(n):
            body()
        t = (time.perf_counter_ns() - t0) / n
        if recording:
            P.stop_recording()
        return t

    def one_span():
        with P.span("cost"):
            pass

    return (statistics.median(once(one_span) for _ in range(runs)),
            statistics.median(once(lambda: P.count("cost"))
                              for _ in range(runs)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 16)
    ap.add_argument("--windows", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)

    import torch
    from port_bench import harness, manifest, program
    from jpeg_tpu_torch.utils import profiling as P

    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    cell = manifest.find_cell(ROOT, args.workload)
    codec = harness.codec_of(cell.config)
    kind, batch = cell.traffic["takes"], int(cell.traffic.get("batch", 1))
    pool_n = int(cell.traffic["pool"])
    call = harness.make_call(ROOT, cell, program.import_program(), "cuda")
    pool, _ = harness.make_pool(ROOT, cell, codec, kind, args.seed, pool_n,
                                dev)
    stream = harness.input_stream(pool_n, args.seed)

    def one() -> int:
        items = [pool[next(stream)] for _ in range(batch)]
        return len(call(items))

    for _ in range(pool_n):
        one()
    t = time.perf_counter()
    while time.perf_counter() - t < harness.WARM_S:
        one()
    torch.cuda.synchronize(dev)

    times = {False: [], True: []}
    spans, counts, answers_on, n_spans, rows = {}, {}, 0, 0, []
    for w in range(2 * args.windows):
        on = w % 4 in (1, 2)
        if on:
            P.start_recording()
        mine, answers = [], 0
        t_first = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            answers += one()
            t1 = time.perf_counter()
            mine.append(t1 - t0)
            if t1 - t_first >= args.seconds:
                break
        if on:
            P.stop_recording()
            rec = P.recorded()
            for s in rec.spans:
                spans[s.name] = (spans.get(s.name, 0.0)
                                 + (s.end_ns - s.start_ns) * 1e-9)
            for k, v in rec.counts.items():
                counts[k] = counts.get(k, 0) + v
            answers_on += answers
            n_spans += len(rec.spans)
        times[on] += mine
        rows.append({"window": w, "recording": on, "calls": len(mine),
                     "median_ms": statistics.median(mine) * 1e3})
        print(f"window {w:2d} recording {'on ' if on else 'off'}: "
              f"{len(mine)} calls, median "
              f"{rows[-1]['median_ms']:.6f} ms", flush=True)

    result = {
        "workload": args.workload, "seed": args.seed, "card": card(),
        "windows_each": args.windows, "window_s": args.seconds,
        "median_call_ms_on": statistics.median(times[True]) * 1e3,
        "median_call_ms_off": statistics.median(times[False]) * 1e3,
        "calls_on": len(times[True]), "calls_off": len(times[False]),
        "per_answer_ms": {k: v / answers_on * 1e3
                          for k, v in sorted(spans.items())},
        "per_answer_counts": {k: v / answers_on
                              for k, v in sorted(counts.items())},
        "windows": rows}
    for on in (False, True):
        sp, ct = span_ns(P, on)
        result[f"span_ns_{'on' if on else 'off'}"] = sp
        result[f"count_ns_{'on' if on else 'off'}"] = ct
    result["spans_per_answer"] = n_spans / answers_on
    on_ms, off_ms = result["median_call_ms_on"], result["median_call_ms_off"]
    print(f"median call: on {on_ms:.6f} ms, off {off_ms:.6f} ms "
          f"(x {on_ms / off_ms:.4f})")
    for k, v in result["per_answer_ms"].items():
        print(f"  {k:>16s}: {v:.6f} ms an answer")
    print(f"one span: off {result['span_ns_off']:.1f} ns, on "
          f"{result['span_ns_on']:.1f} ns; one count: off "
          f"{result['count_ns_off']:.1f} ns, on {result['count_ns_on']:.1f} "
          f"ns; {result['spans_per_answer']:.2f} spans an answer")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
