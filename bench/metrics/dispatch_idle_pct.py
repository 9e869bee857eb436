"""Share of the traced part in which the card runs nothing while the host
is inside ``engine.dispatch`` or ``engine.prefill.dispatch``: the idle that
only a faster dispatch of the decode step and the re-prefill can recover
(the device trace's gaps intersected with the program's dispatch spans)."""
from bench import spans

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "tokens_per_s"


def read(run):
    sp = spans.of(run)
    if not sp or run.trace.window_s <= 0:
        return None
    host = spans.intervals(sp, "engine.dispatch", "engine.prefill.dispatch")
    if not host:
        return None
    idle = spans.overlap_ns(host, spans.union(run.trace.gaps()))
    return 100.0 * idle / (run.trace.window[1] - run.trace.window[0])
