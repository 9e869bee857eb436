"""Share of the traced window in which no kernel, copy or set ran on the
card (the union of the device intervals in the ``torch.profiler`` trace)."""
LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "tokens_per_s"


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
