"""KNN-LM's host interpolation a served token: the self time of the
program's ``knn.interpolate`` spans (both roles: the speculation step's and
verification's recomputation) over the tokens of the traced part's
requests."""
from bench import spans

LAYER = "servers"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "tokens_per_s"


def read(run):
    sp = spans.of(run)
    n = spans.tokens(sp) if sp else 0
    t = spans.self_ns(sp, "knn.interpolate") if n else []
    return sum(t) / 1e6 / n if t else None
