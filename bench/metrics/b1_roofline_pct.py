"""B1 (the EDR scan, ``kernels/dense_topk.py``): the least time of the
traced window's merged KB calls (each call's KB read once, its queries and
its k results; or its 2 N d operations a query at the fp32 rate, whichever
is longer) over the device time of B1's kernels in the trace."""
from bench.yardstick import bound_s, dense_topk_work

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "tokens_per_s"
KERNELS = ("scan_kernel", "topk_merge_kernel", "topk_select_kernel")


def read(run):
    if run.trace is None or not run.rec.kb_shapes:
        return None
    t = run.trace.device_time(*KERNELS)
    if t <= 0:
        return None
    N, d = run.kb_rows, run.cfg["key_dim"]
    need = sum(bound_s(*dense_topk_work(B, N, d, min(k, N))) for B, k in run.rec.kb_shapes)
    return 100.0 * need / t
