"""call_p95_ms.<split>: the 95th percentile (nearest rank) of the host-clock
time of every call in the traced window (ms).  Where a cell's own tail
spreads too widely from run to run to hold a bound, it is read here."""
from port_bench.harness import percentile_ms


def read(run, name):
    if not run.call_s or run.answers == 0:
        return None
    return percentile_ms(run.call_s, 95)
