"""Host time to enqueue one per-slot prefill: the mean self time of the
program's ``engine.prefill.dispatch`` spans (``Model.prefill`` and the row
scatter into the batched state, before the prefill's closing
synchronisation) in the traced part."""
from bench import spans

LAYER = "engines"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "tokens_per_s"


def read(run):
    sp = spans.of(run)
    t = spans.self_ns(sp, "engine.prefill.dispatch") if sp else []
    return sum(t) / len(t) / 1e6 if t else None
