"""band_build_ms.<split>: host-clock time of the API's construction of a
``BandDecoder`` and its ``.to(device)``, per construction (in ms).

The span wraps ``jpeg_tpu_torch.api.BandDecoder``, the name the API
calls, in the traced run only."""
import time

WRAPS = ("jpeg_tpu_torch.api", "BandDecoder")
SPAN = "band_build"


def install(spans):
    from jpeg_tpu_torch import api
    orig = api.BandDecoder

    class Timed(orig):
        def __init__(self, *args, **kwargs):
            t0 = time.perf_counter()
            super().__init__(*args, **kwargs)
            object.__setattr__(self, "_span_t0", t0)

        def to(self, *args, **kwargs):
            out = super().to(*args, **kwargs)
            t0 = self.__dict__.pop("_span_t0", None)
            if t0 is not None:
                spans.add(SPAN, t0, time.perf_counter())
            return out

    api.BandDecoder = Timed

    def undo():
        api.BandDecoder = orig
    return undo


def read(run, name):
    got = run.spans.by_name.get(SPAN)
    if not got:
        return None
    return sum(got) / len(got) * 1e3
