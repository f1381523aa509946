"""band_upload_ms.<split>: the host's time moving band modules' buffers to
the device (the program's ``band.to_device`` spans), per answer (ms)."""


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
    return got.seconds("band.to_device") / run.answers * 1e3
