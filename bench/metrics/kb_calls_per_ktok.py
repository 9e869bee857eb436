"""Merged KB calls per 1000 served tokens: the fleet's own count
(``FleetResult.kb_calls``: the seed call and one call a round) over the
window's tokens. Speculation that verifies more steps a call lowers it."""
LAYER = "servers"
UNIT = "calls/ktok"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "tokens_per_s"


def read(run):
    tokens = run.window.tokens
    return 1000.0 * sum(g["kb_calls"] for g in run.window.groups) / tokens if tokens else None
