"""B1: the EDR full scan with a canonical top-k (``csrc/dense_topk.cu``).

Counterpart of ``repro.kernels.dense_topk.dense_topk_pallas``: queries (B, d)
f32 against a KB (N, d) f32 -> (scores (B, k) f32, ids (B, k) int32), rows in
the canonical order (score descending, then id ascending), which is the order
``repro.retrieval.backends.canonical_topk`` and the Pallas merge produce.

:func:`dense_topk` runs the CUDA kernel on CUDA tensors and the plain PyTorch
version (:func:`dense_topk_plain`) on CPU tensors. ``launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG = -3.4e38          # pad sentinel of the kernel (score), with id -1
MAX_K = 256            # largest k the kernel takes (prefetch_top_k <= 256)
launches = 0


def dense_topk_plain(queries: torch.Tensor, kb: torch.Tensor, k: int):
    """One fp32 product and a stable descending sort: ties keep their id
    order, so equal scores come out id-ascending."""
    s = queries.float() @ kb.float().T
    scores, ids = torch.sort(s, dim=1, descending=True, stable=True)
    return scores[:, :k].contiguous(), ids[:, :k].to(torch.int32)


def _launch_fn():
    lib = _build.library("dense_topk")
    fn = lib.dense_topk_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, p]
        fn.restype = i
        lib.dense_topk_split_rows.argtypes = [i]
        lib.dense_topk_split_rows.restype = i
    return fn, lib.dense_topk_split_rows


def dense_topk(queries: torch.Tensor, kb: torch.Tensor, k: int):
    """queries (B, d), kb (N, d) -> (scores (B, k) f32, ids (B, k) int32)."""
    global launches
    if queries.ndim != 2 or kb.ndim != 2 or queries.shape[1] != kb.shape[1]:
        raise ValueError(f"dense_topk: shapes {tuple(queries.shape)} x "
                         f"{tuple(kb.shape)}")
    B, d = queries.shape
    N = kb.shape[0]
    if not 1 <= k <= N:
        raise ValueError(f"dense_topk: k={k} outside [1, N={N}]")
    if _build.on_cpu("dense_topk", queries, kb):
        return dense_topk_plain(queries, kb, k)
    if k > MAX_K:
        raise ValueError(f"dense_topk: the kernel takes k <= {MAX_K}, got {k}")
    if d % 4:
        raise ValueError(f"dense_topk: the kernel takes d % 4 == 0, got d={d}")
    _build.check_kernel_inputs("dense_topk", torch.float32, queries, kb)
    fn, split_rows = _launch_fn()
    n_splits = -(-N // split_rows(B))
    dev = queries.device
    # per-split partial lists plus room for the merge levels' lists
    partial = torch.empty((B * k * (n_splits + -(-n_splits // 8)),),
                          dtype=torch.int64, device=dev)
    scores = torch.empty((B, k), dtype=torch.float32, device=dev)
    ids = torch.empty((B, k), dtype=torch.int32, device=dev)
    rc = fn(queries.data_ptr(), kb.data_ptr(), partial.data_ptr(),
            scores.data_ptr(), ids.data_ptr(), B, N, d, k,
            _build.stream_ptr(dev))
    launches += 1
    _build.check(rc, "dense_topk")
    return scores, ids
