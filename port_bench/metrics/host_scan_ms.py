"""host_scan_ms.<split>: host-clock time of the API's calls into the
boundary scan, whichever it takes, summed and divided by the answers
returned (in ms): ``jpeg_tpu_torch.entropy.scan_offsets`` (the host scan,
three bands a frame on three threads) and
``jpeg_tpu_torch.entropy.device_scan.scan_bands_starts`` (the enqueue of
the device scan, K6 then K8, which a CUDA decode's ``scan="auto"`` takes).
The wrappers are installed in the traced run only."""

WRAPS = (("jpeg_tpu_torch.entropy", "scan_offsets"),
         ("jpeg_tpu_torch.entropy.device_scan", "scan_bands_starts"))
SPAN = "host_scan"


def install(spans):
    import importlib
    undos = []
    for module, name in WRAPS:
        mod = importlib.import_module(module)
        orig = getattr(mod, name)

        def timed(*args, _orig=orig, **kwargs):
            with spans.span(SPAN):
                return _orig(*args, **kwargs)

        setattr(mod, name, timed)
        undos.append((mod, name, orig))

    def undo():
        for mod, name, orig in undos:
            setattr(mod, name, orig)
    return undo


def read(run, name):
    got = run.spans.by_name.get(SPAN)
    if not got or run.answers == 0:
        return None
    return sum(got) / run.answers * 1e3
