"""B6: the EDR full scan over an int8 KB (``csrc/dense_topk.cu``, B1's scan
templated on int8 rows).

Counterpart of ``repro.kernels.dense_topk.quant_topk_pallas``: queries (B, d)
f32 against codes (N, d) int8 with per-row scales (N,) f32 -> the top k of
``(q @ float(codes).T) * scales`` as (scores (B, k) f32, ids (B, k) int32),
in the canonical order (score descending, then id ascending). The scale
multiplies the finished score, the TPU kernel's order.

:func:`quant_dense_topk` runs the CUDA kernel on CUDA tensors and the plain
PyTorch version (:func:`quant_dense_topk_plain`) on CPU tensors.
``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dense_topk import launch, pad_d

launches = 0


def quant_dense_topk_plain(queries: torch.Tensor, codes: torch.Tensor,
                           scales: torch.Tensor, k: int):
    """One fp32 product over the cast codes, the scales on the scores, and a
    stable descending sort: ties keep their id order."""
    s = (queries.float() @ codes.float().T) * scales.float()
    scores, ids = torch.sort(s, dim=1, descending=True, stable=True)
    return scores[:, :k].contiguous(), ids[:, :k].to(torch.int32)


def quant_dense_topk(queries: torch.Tensor, codes: torch.Tensor,
                     scales: torch.Tensor, k: int):
    """queries (B, d) f32, codes (N, d) int8, scales (N,) f32
    -> (scores (B, k) f32, ids (B, k) int32)."""
    global launches
    if queries.ndim != 2 or codes.ndim != 2 or queries.shape[1] != codes.shape[1] \
            or scales.shape != codes.shape[:1]:
        raise ValueError(f"quant_dense_topk: shapes {tuple(queries.shape)} x "
                         f"{tuple(codes.shape)}, scales {tuple(scales.shape)}")
    B = queries.shape[0]
    N = codes.shape[0]
    if not 1 <= k <= N:
        raise ValueError(f"quant_dense_topk: k={k} outside [1, N={N}]")
    if _build.on_cpu("quant_dense_topk", queries, codes, scales):
        return quant_dense_topk_plain(queries, codes, scales, k)
    _build.check_kernel_inputs("quant_dense_topk", torch.float32, queries, scales)
    _build.check_kernel_inputs("quant_dense_topk", torch.int8, codes)
    queries, codes = pad_d(queries, 16), pad_d(codes, 16)
    out = launch("dense_topk", "quant_topk_launch", (queries, codes, scales),
                 (B, N, codes.shape[1], k), B, N, k)
    launches += 1
    return out
