"""One run of one cell: set-up, the measured window, the check, the result.

The loop is closed: each call is made when the previous one has returned,
as a data loader or an archiver waits for its codec.  A call takes the
mix's next ``batch`` inputs from a stream of seeded shuffles of a pool of
``pool`` distinct inputs, one shuffle after another and never one input
twice in a row, so consecutive calls differ and a chunk of a multiple of
``pool`` inputs holds each input equally often.  Set-up warms every pool
input once and then runs the loop for a fixed ``WARM_S`` seconds; the
window ends with the first call that returns after ``--seconds``.

End-to-end metrics are taken on the host clock, with nothing wrapped,
from the names BENCHMARK.json gives them: ``setup_s`` is the time from
the process's start to the first timed call, less the seconds the
reference spent writing the decode cells' containers into an empty cache
(the reference's time is not the program's), ``<x>_mps`` the frame pixels
(H * W) of every answer returned in the window over the window's seconds
(first call's start to last call's end), and ``<x>_p<q>_ms`` the q-th
percentile (nearest rank) of every call's time.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import json
import math
import os
import random
import re
import sys
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from . import checks, manifest, program
from . import trace as T
from .frames import synth_frames
from .reference import codec as R

HERE = os.path.dirname(os.path.abspath(__file__))

#: Seconds of the loop run in set-up after every pool input was warmed, so
#: that the allocator and the clocks are in their steady state before the
#: window opens.
WARM_S = 2.0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class RunView:
    """What a per-layer metric's reader reads, after the window."""
    config: Dict
    codec: R.Codec
    traffic: Dict
    answers: int                  # answers returned in the window
    calls: int
    call_s: List[float]           # each call's host-clock seconds
    window_s: float               # host clock
    container_bytes: float        # mean container size of those answers
    device: Optional[T.DeviceTrace]
    spans: T.Spans
    log: Callable[[str], None]


def codec_of(config: Dict) -> R.Codec:
    fr = config["frame"]
    return R.Codec.from_settings(config["codec"], fr["height"], fr["width"])


def _cache_dir(root: str, cell: manifest.Cell) -> str:
    """Where the reference's containers for this configuration live: keyed
    by the configuration and the code that makes them."""
    h = hashlib.sha256(json.dumps(cell.config, sort_keys=True).encode())
    for name in ("frames.py", os.path.join("reference", "codec.py")):
        with open(os.path.join(HERE, name), "rb") as f:
            h.update(f.read())
    return os.path.join(root, manifest.BENCH_DIR, "cache",
                        f"{cell.config_name}-{h.hexdigest()[:12]}")


def reference_containers(root: str, cell: manifest.Cell, codec: R.Codec,
                         seed: int, count: int, device) -> List[bytes]:
    """The pool's containers, written by the reference encoder from the
    seed's frames, and cached inside the checkout.  Where the cache is
    empty the frames and the encode are the reference's work."""
    d = os.path.join(_cache_dir(root, cell), str(seed))
    paths = [os.path.join(d, f"{i}.jc") for i in range(count)]
    if all(os.path.exists(p) for p in paths):
        out = []
        for p in paths:
            with open(p, "rb") as f:
                out.append(f.read())
        return out
    frames = synth_frames(count, codec.height, codec.width, seed, device)
    out = [R.encode_container(codec, f) for f in frames]
    os.makedirs(d, exist_ok=True)
    for p, blob in zip(paths, out):
        tmp = f"{p}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, p)
    return out


def make_pool(root: str, cell: manifest.Cell, codec: R.Codec, kind: str,
              seed: int, count: int, device) -> Tuple[List, float]:
    """The pool of distinct inputs, and the seconds the reference spent
    making them: host frames made on the device, or the reference's
    containers of them.  Host frames live in memory numpy allocates, as a
    caller's arrays do."""
    if kind == "frames":
        frames = synth_frames(count, codec.height, codec.width, seed, device)
        host = np.empty(tuple(frames.shape), dtype=np.uint8)
        torch.from_numpy(host).copy_(frames)
        return list(host), 0.0
    t0 = time.perf_counter()
    pool = reference_containers(root, cell, codec, seed, count, device)
    return pool, time.perf_counter() - t0


def input_stream(pool_n: int, seed: int) -> Iterator[int]:
    """Pool indices without end: seeded shuffles of the pool, one after
    another, with no index twice in a row."""
    rng = random.Random(seed)
    last = None
    while True:
        order = list(range(pool_n))
        rng.shuffle(order)
        if pool_n > 1 and order[0] == last:
            order.append(order.pop(0))
        yield from order
        last = order[-1]


def make_call(root: str, cell: manifest.Cell, api, device: str):
    """The mix's call: its own ``make_call`` where it brings one, else the
    one ``program.py`` makes from its JSON."""
    fr = cell.config["frame"]
    code = manifest.mix_code(root, cell.traffic_name)
    make = code.make_call if code is not None else program.make_call
    return make(api, cell.traffic, cell.config["codec"], fr["height"],
                fr["width"], device)


def percentile_ms(call_s: List[float], q: int) -> float:
    """The q-th percentile (nearest rank) of the calls' seconds, in ms."""
    s = sorted(call_s)
    return s[max(0, math.ceil(q / 100 * len(s)) - 1)] * 1e3


def end_to_end_value(name: str, setup_s: float, pixels: int,
                     window_s: float, call_s: List[float]) -> float:
    if name == "setup_s":
        return setup_s
    if name.endswith("_mps"):
        return pixels / window_s / 1e6
    m = re.fullmatch(r".+_p(\d+)_ms", name)
    if m:
        return percentile_ms(call_s, int(m.group(1)))
    raise ValueError(f"no rule computes the end-to-end metric {name!r}")


def execute(root: str, cell_name: str, seed: int, seconds: float,
            traced: bool, device: str = "cuda",
            t_start: Optional[float] = None) -> Dict:
    """Run the cell once and return the result line as a dict."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = manifest.find_cell(root, cell_name)
    config, traffic = cell.config, cell.traffic
    codec = codec_of(config)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    kind = traffic["takes"]
    batch = int(traffic.get("batch", 1))
    pool_n = int(traffic["pool"])
    readers = ([(m, manifest.metric_reader(root, m["name"]))
                for m in cell.per_layer] if traced else [])

    api = program.import_program()
    call = make_call(root, cell, api, device)
    pool, reference_s = make_pool(root, cell, codec, kind, seed, pool_n, dev)
    log(f"reference: {reference_s:.6f} s making the pool's inputs "
        f"(not counted in setup_s)")
    stream = input_stream(pool_n, seed)
    rng = random.Random(seed + 1)                # the answers' sample

    def inputs() -> List[int]:
        return [next(stream) for _ in range(batch)]

    # Warm-up: the cell's own shapes, every pool input once, then the loop
    # for WARM_S seconds.
    warmed = set()
    while len(warmed) < pool_n:
        idx = inputs()
        call([pool[i] for i in idx])
        warmed.update(idx)
    t_warm = time.perf_counter()
    while time.perf_counter() - t_warm < WARM_S:
        call([pool[i] for i in inputs()])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    spans = T.Spans()
    undo = [r.install(spans) for _, r in readers if hasattr(r, "install")]
    prof = T.profiler(dev) if traced else contextlib.nullcontext()
    keep = 2                                   # answers sampled per input
    samples: Dict[int, List] = {i: [] for i in range(pool_n)}
    seen = {i: 0 for i in range(pool_n)}
    call_s, attempted, answered, sizes = [], 0, 0, []
    first_error = None
    setup_s = time.perf_counter() - t_start - reference_s
    with prof:
        with (torch.profiler.record_function(T.WINDOW) if traced
              else contextlib.nullcontext()):
            t_first = time.perf_counter()
            while True:
                idx = inputs()
                t0 = time.perf_counter()
                try:
                    outs = list(call([pool[i] for i in idx]))
                except Exception as e:             # counted as missing
                    outs, first_error = [], first_error or e
                t1 = time.perf_counter()
                call_s.append(t1 - t0)
                attempted += len(idx)
                for i, out in zip(idx, outs):
                    answered += 1
                    sizes.append(len(out) if kind == "frames"
                                 else len(pool[i]))
                    seen[i] += 1
                    if len(samples[i]) < keep:
                        samples[i].append(out)
                    else:
                        j = rng.randrange(seen[i])
                        if j < keep:
                            samples[i][j] = out
                del outs
                if t1 - t_first >= seconds:
                    break
    window_s = t1 - t_first
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    for u in undo:
        u()
    if first_error is not None:
        log(f"a call raised: {first_error!r}")
    cs = sorted(call_s)
    log(f"window {window_s:.6f} s: {len(call_s)} calls, {attempted} inputs, "
        f"{answered} answers; call seconds min {cs[0]:.6f} median "
        f"{cs[len(cs) // 2]:.6f} max {cs[-1]:.6f}")

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    metrics, breakdown = {}, None
    if traced:
        dt = T.reduce(prof)
        device_info["busy_s"] = dt.busy_s
        device_info["window_s"] = dt.window_s
        breakdown = {"device_ops": [[n, s] for n, s in dt.ops],
                     "idle_gaps": [[n, s] for n, s in dt.idle]}
        view = RunView(config, codec, traffic, answered, len(call_s),
                       call_s, window_s, sum(sizes) / max(1, len(sizes)), dt,
                       spans, log)
        for m, r in readers:
            v = r.read(view, m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        pixels = answered * codec.height * codec.width
        for m in cell.end_to_end:
            v = end_to_end_value(m["name"], setup_s, pixels, window_s, call_s)
            if re.fullmatch(r".+_p\d+_ms", m["name"]):
                log(f"{m['name']}: nearest-rank percentile of "
                    f"{len(call_s)} calls")
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # The check, once the window has closed and the peak is read.
    ref = checks.Reference(codec, kind, pool, dev)
    found = checks.judge(ref, samples, attempted - answered)
    log(f"checked {sum(map(len, samples.values()))} sampled answers of "
        f"{answered}")
    result = {"correct": checks.passed(found), "attempted": attempted,
              "failed": attempted - answered, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = found
    return result
