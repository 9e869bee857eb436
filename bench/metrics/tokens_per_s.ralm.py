"""The window's served tokens over its length, the end-to-end rate of the
cells that report ``tokens_per_s``, here per layer: in these cells the
host's speed, which drifts between runs on the machine, moves it by more
than a bound may hold."""
LAYER = "servers"
UNIT = "tokens/s"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "device_ms_per_tok"


def read(run):
    w = run.window
    return w.tokens / w.seconds if w.tokens and w.seconds > 0 else None
