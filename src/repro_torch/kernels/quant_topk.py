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

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dense_topk import MAX_K, _launch_fn

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
    B, d = queries.shape
    N = codes.shape[0]
    if not 1 <= k <= N:
        raise ValueError(f"quant_dense_topk: k={k} outside [1, N={N}]")
    if _build.on_cpu("quant_dense_topk", queries, codes, scales):
        return quant_dense_topk_plain(queries, codes, scales, k)
    if k > MAX_K:
        raise ValueError(f"quant_dense_topk: the kernel takes k <= {MAX_K}, got {k}")
    if d % 16:
        raise ValueError(f"quant_dense_topk: the kernel takes d % 16 == 0, got d={d}")
    _build.check_kernel_inputs("quant_dense_topk", torch.float32, queries, scales)
    _build.check_kernel_inputs("quant_dense_topk", torch.int8, codes)
    lib = _build.library("dense_topk")
    fn = lib.quant_topk_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 6 + [i] * 4 + [p]
        fn.restype = i
    _, split_rows = _launch_fn()             # B1's split, same library
    n_splits = -(-N // split_rows(B))
    dev = queries.device
    # per-split partial lists plus room for the merge levels' lists
    partial = torch.empty((B * k * (n_splits + -(-n_splits // 8)),),
                          dtype=torch.int64, device=dev)
    scores = torch.empty((B, k), dtype=torch.float32, device=dev)
    ids = torch.empty((B, k), dtype=torch.int32, device=dev)
    rc = fn(queries.data_ptr(), codes.data_ptr(), scales.data_ptr(), partial.data_ptr(),
            scores.data_ptr(), ids.data_ptr(), B, N, d, k, _build.stream_ptr(dev))
    launches += 1
    _build.check(rc, "quant_dense_topk")
    return scores, ids
