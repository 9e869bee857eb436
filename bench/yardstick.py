"""The yardstick: the card's published peaks and the operations and bytes of
the work the benchmark measures, computed from shapes.

The arithmetic is copied from the port's chip smoke run (``bound_ms``,
``decode_bytes``) and frozen here so that a change to the program cannot
move it; a model's FLOPs a token (2 a parameter a token, as the JAX
benchmarks' roofline counts) live in its model module under
``bench/reference/``. Every input is counted read once and every output
written once.
"""
from __future__ import annotations

# the dense decoder's model FLOPs; a configuration's own are its model
# module's ``token_flops`` (``bench.cells.model``)
from bench.reference.model import dense_params, token_flops  # noqa: F401

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
