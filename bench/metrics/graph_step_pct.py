"""Share of the lockstep decode steps that replayed a CUDA graph: the
program's ``engine.dispatch`` spans in the traced part whose ``graph``
attribute is 1 (``BatchedServeEngine`` sets it from the step's graph
counter), over all of them. A program whose dispatch spans carry no
``graph`` attribute reads nothing."""
from bench import spans

LAYER = "engines"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_span"
MOVES = "tokens_per_s"


def read(run):
    sp = spans.of(run)
    steps = [s for s in sp or () if s.name == "engine.dispatch"]
    if not any("graph" in s.attrs for s in steps):
        return None
    return 100.0 * sum(s.attrs.get("graph", 0) for s in steps) / len(steps)
