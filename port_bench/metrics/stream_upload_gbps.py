"""stream_upload_gbps.<split>: the rate at which a decode moves its band
bytes to the device: the window's ``decode.stream_bytes`` counter (the
bands' bytes each decode moved) over the seconds of its ``decode.upload``
spans, in GB/s (1e9 bytes a second).  On the device scan those spans hold
the stream's copy alone; on the host scan also the block starts' copy.
Nothing where the program counts no stream bytes."""


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
    moved = got.counts.get("decode.stream_bytes", 0)
    seconds = got.seconds("decode.upload")
    if moved <= 0 or seconds <= 0:
        return None
    return moved / seconds / 1e9
