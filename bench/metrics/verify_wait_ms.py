"""The main thread's wait on its merged KB call, mean over the traced
part's rounds: an inline ``fleet.verify`` on the round's own thread, or
``fleet.join`` (the wait in the future's result) where the call ran on the
worker beside the overlapped stride. 0 means the overlap hides the call."""
from bench import spans

LAYER = "retrieval"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "tokens_per_s"


def read(run):
    sp = spans.of(run)
    rounds = {s.id: s for s in sp if s.name == "fleet.round"} if sp else {}
    if not rounds:
        return None
    wait = sum(s.t1_ns - s.t0_ns for s in sp if s.parent in rounds and (
        s.name == "fleet.join"
        or (s.name == "fleet.verify" and s.thread == rounds[s.parent].thread)))
    return wait / len(rounds) / 1e6
