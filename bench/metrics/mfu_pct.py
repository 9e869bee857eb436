"""Model FLOPs of the window's served tokens over the window's length times
the card's fp32 peak (67 TFLOP/s: the port serves fp32, TF32 off). A token
costs 2 FLOPs a non-embedding weight and a head weight, plus attention over
its context (the passage, the prompt and the tokens before it)."""
from bench.yardstick import PEAK_FP32_FLOPS, token_flops

LAYER = "model"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "tokens_per_s"


def read(run):
    cfg, w = run.cfg, run.window
    if not w.tokens or w.seconds <= 0:
        return None
    lead = cfg.get("passage_tokens", 0) if cfg["workload"] == "ralm" else 0
    flops = sum(token_flops(cfg, lead + len(r["prompt"]) + j + 1)
                for r in w.requests for j in range(len(r["tokens"])))
    return 100.0 * flops / (w.seconds * PEAK_FP32_FLOPS)
