"""Generation time per served token: the fleet's G ledger (the engine's
prefill and decode time of each group, host clock around work that ends in
a synchronize) over the window's tokens."""
LAYER = "engines"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "tokens_per_s"


def read(run):
    tokens = run.window.tokens
    return 1000.0 * sum(g["gen_time"] for g in run.window.groups) / tokens if tokens else None
