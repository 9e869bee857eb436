"""The yardstick: the card's published peaks and the operations and bytes of
the work the benchmark measures, computed from shapes.

The arithmetic is copied from the port's chip smoke run (``bound_ms``,
``decode_bytes``) and from the JAX benchmarks' roofline (2 FLOPs a
parameter a token), and frozen here so that a change to the program cannot
move it. Every input is counted read once and every output written once.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates: HBM3 bandwidth and the fp32 rate
# outside the tensor cores (the port serves fp32 with TF32 off)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: bytes at the bandwidth or
    operations at the fp32 rate, whichever is longer."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS)


def dense_topk_work(B: int, N: int, d: int, k: int) -> tuple:
    """(bytes, flops) of one exact top-k scan (B1): the KB and the queries
    read once, k (score, id) pairs written per query; 2 N d operations a
    query."""
    return 4.0 * (N * d + B * d + 2 * B * k), 2.0 * B * N * d


def decode_attention_work(lens, W: int, H: int, KV: int, hd: int) -> tuple:
    """(bytes, flops) of one decode-attention call (B2) over a ring of W
    entries: q and out, the valid keys and values (a slot at cache_len <= 0
    reads the window's values), the lengths; 4 operations per query head,
    head element and valid entry (q.k and p.v)."""
    lens = [int(x) for x in lens]
    n = sum(min(x, W) for x in lens if x > 0)
    n_mean = sum(1 for x in lens if x <= 0) * W
    B = len(lens)
    nbytes = 4.0 * (2 * B * H * hd + (2 * n + n_mean) * KV * hd + B)
    flops = 4.0 * H * hd * (n + n_mean)
    return nbytes, flops


def dense_params(cfg: dict) -> tuple:
    """(non-embedding parameters, LM head parameters) of a dense decoder as
    the port builds it: per layer q/k/v/o (with biases where qkv_bias, and
    q and k norms where qk_norm), the SwiGLU FFN and two norms; the final
    norm; the head (the embedding itself where tied: its products count
    all the same)."""
    d, H, KV, hd = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    attn = d * (H + 2 * KV) * hd + H * hd * d
    if cfg.get("qkv_bias"):
        attn += (H + 2 * KV) * hd
    if cfg.get("qk_norm"):
        attn += 2 * hd
    per_layer = attn + 3 * d * cfg["d_ff"] + 2 * d
    return cfg["num_layers"] * per_layer + d, d * cfg["vocab_size"]


def token_flops(cfg: dict, context: int) -> float:
    """Model FLOPs of one token at a position with ``context`` tokens before
    and including it: 2 per weight (non-embedding and head), plus attention's
    q.k and p.v over the context in every layer."""
    body, head = dense_params(cfg)
    attn = 4.0 * cfg["num_layers"] * cfg["num_heads"] * cfg["head_dim"] * context
    return 2.0 * (body + head) + attn
