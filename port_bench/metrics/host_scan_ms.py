"""host_scan_ms.<split>: host-clock time of the API's calls into
``jpeg_tpu_torch.entropy.scan_offsets`` (the boundary scan, three bands a
frame on three threads), summed and divided by the answers returned (in
ms).  The wrapper is installed in the traced run only."""

WRAPS = ("jpeg_tpu_torch.entropy", "scan_offsets")
SPAN = "host_scan"


def install(spans):
    from jpeg_tpu_torch import entropy
    orig = entropy.scan_offsets

    def timed(*args, **kwargs):
        with spans.span(SPAN):
            return orig(*args, **kwargs)

    entropy.scan_offsets = timed

    def undo():
        entropy.scan_offsets = orig
    return undo


def read(run, name):
    got = run.spans.by_name.get(SPAN)
    if not got or run.answers == 0:
        return None
    return sum(got) / run.answers * 1e3
