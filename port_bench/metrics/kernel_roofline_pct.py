"""kernel_roofline_pct.<split>: the least time the card needs for one
frame's device work, over the device kernel time per frame (in %).

The least time is the larger of the bytes over 3.35 TB/s and the
operations over 495 TFLOP/s (the TF32 tensor-core rate, at which the f32
products can be done in f32 accuracy).  Bytes: the frame's pixels (H x W x
3 bytes) read or written once, and its container read or written once.
Operations: the 2-D transform of every block of the three bands done as
two 1-D passes, d^3 multiply-adds each, so 4 d^3 operations a block; that
is the least any evaluation order needs, so the count holds whichever
kernel does the work.  The kernel time sums every kernel the profiler saw
in the window, whatever implements the work, and divides by the answers
returned.
"""
import subprocess

from port_bench.peaks import TF32_FLOP_PER_S, bound


def frame_work(codec, container_bytes):
    """(bytes, operations) of one frame's device work."""
    nbytes = codec.height * codec.width * 3 + container_bytes
    flops = 3 * codec.num_blocks * 4 * codec.dct_size ** 3
    return nbytes, flops


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def read(run, name):
    dt = run.device
    if dt is None or run.answers == 0 or dt.kernel_s <= 0:
        return None
    nbytes, flops = frame_work(run.codec, run.container_bytes)
    least, side = bound(nbytes, flops, TF32_FLOP_PER_S)
    per_frame = dt.kernel_s / run.answers
    run.log(f"{name}: least {least * 1e3:.6f} ms a frame ({side}: "
            f"{nbytes:.0f} bytes, {flops} operations), kernels "
            f"{per_frame * 1e3:.6f} ms a frame; card: {power_limit()}")
    return 100.0 * least / per_frame
