"""device_idle_pct.<split>: the share of the traced window in which no
kernel, copy or fill ran on the device, from torch.profiler's CUDA
activity (in %)."""


def read(run, name):
    dt = run.device
    if dt is None or dt.window_s <= 0 or dt.busy_s <= 0:
        return None
    return 100.0 * (1.0 - dt.busy_s / dt.window_s)
