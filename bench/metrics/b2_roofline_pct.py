"""B2 (decode attention, ``kernels/decode_attention.py``): the least time of
the traced window's decode steps (in every attention layer of the
configuration's model module, each slot's valid ring entries read once, q
read and the output written; or the operations at the fp32 rate, whichever
is longer) over the device time of B2's kernels."""
from bench.yardstick import bound_s, decode_attention_work

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "tokens_per_s"
KERNELS = ("decode_attn_kernel", "decode_wide_kernel")


def read(run):
    if run.trace is None or not run.rec.decode_lens:
        return None
    t = run.trace.device_time(*KERNELS)
    if t <= 0:
        return None
    cfg, W = run.cfg, run.cfg["cache_window"]
    need = sum(bound_s(*decode_attention_work([min(p + 1, W) for p in pos], W,
                                              cfg["num_heads"], cfg["num_kv_heads"],
                                              cfg["head_dim"]))
               for pos in run.rec.decode_lens) * len(run.model.attention_layers(cfg))
    return 100.0 * need / t
