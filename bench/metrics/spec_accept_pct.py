"""Share of verified speculative steps that verification kept: each
slot-round's steps before its first mis-speculated one, over all the steps
it verified (read from the workload's ``check_and_commit`` as the fleet
calls it)."""
LAYER = "servers"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "tokens_per_s"


def read(run):
    steps = sum(n for n, _ in run.window.spec_steps)
    return 100.0 * sum(m for _, m in run.window.spec_steps) / steps if steps else None
