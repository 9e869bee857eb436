"""The model's device time a served token: the card's busy time (the union
of the device intervals, B1's kernels left out) inside the program's
``engine.prefill`` and ``engine.decode`` spans, each of which ends in a
synchronisation, over the tokens of the traced part's requests."""
from pathlib import Path

from bench import spans
from bench.cells import load_module

LAYER = "model"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "tokens_per_s"
B1 = load_module(Path(__file__).with_name("b1_roofline_pct.py"),
                 "bench_metric_b1_roofline_pct").KERNELS


def read(run):
    sp = spans.of(run)
    n = spans.tokens(sp) if sp else 0
    if not n:
        return None
    host = spans.intervals(sp, "engine.prefill", "engine.decode")
    dev = spans.union((s, e) for name, s, e in run.trace.device
                      if not any(k in name for k in B1))
    return spans.overlap_ns(host, dev) / 1e6 / n
