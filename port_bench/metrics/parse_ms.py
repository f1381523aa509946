"""parse_ms.<split>: the program's container parse (its ``decode.parse``
spans: header and band streams read from the container's bytes), per
answer (ms)."""


def _recorder():
    """The program's span recorder, or None where the program has none."""
    try:
        from jpeg_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "start_recording") else None


def install(spans):
    """Record the program's spans and counters over the window."""
    rec = _recorder()
    if rec is None:
        return lambda: None
    rec.start_recording()
    return rec.stop_recording


def _window(run):
    """The window's recording, where the program recorded its decode calls
    and answers came back; else None."""
    rec = _recorder()
    if rec is None or run.answers == 0:
        return None
    got = rec.recorded()
    if not any(s.name == "decode" for s in got.spans):
        return None
    return got


def read(run, name):
    got = _window(run)
    if got is None:
        return None
    return got.seconds("decode.parse") / run.answers * 1e3
