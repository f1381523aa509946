"""transfer_ms.<split>: device time of host<->device copies (the
profiler's ``Memcpy`` events) in the traced window, per answer (in ms)."""


def read(run, name):
    dt = run.device
    if dt is None or run.answers == 0 or dt.copy_s <= 0:
        return None
    return dt.copy_s / run.answers * 1e3
