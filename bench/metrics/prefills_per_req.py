"""Prefills per request (``engine.stats.prefills`` of each group): the
first prefill of each prompt, and in RaLM every re-prefill a passage swap
forces."""
LAYER = "engines"
UNIT = "prefills/req"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "tokens_per_s"


def read(run):
    n = len(run.window.requests)
    return sum(g["prefills"] for g in run.window.groups) / n if n else None
