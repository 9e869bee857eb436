"""Host time to enqueue one lockstep decode step: the mean self time of the
program's ``engine.dispatch`` spans (``Model.decode_step`` inside
``BatchedServeEngine.gen`` / ``advance``) in the traced part. The step's
device work runs after it; the readback that waits for it is its own span."""
from bench import spans

LAYER = "engines"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "tokens_per_s"


def read(run):
    sp = spans.of(run)
    t = spans.self_ns(sp, "engine.dispatch") if sp else []
    return sum(t) / len(t) / 1e6 if t else None
