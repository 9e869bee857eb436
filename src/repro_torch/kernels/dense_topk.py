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


TILE_ROWS = 256        # KB rows per tile of the scan (kTileRows in dense_topk.cu)
_sms: dict = {}


def scan_scratch(B: int, N: int, k: int, sms: int):
    """(lists, bytes) of one B1/B6 kernel call on a card with ``sms`` SMs:
    the scan's CTAs per query block, one per SM and none without a row tile,
    each write one partial list of k sort keys (8 bytes) per query; the merge
    levels take room for ceil(lists / 8) more."""
    lists = max(1, min(-(-N // TILE_ROWS), sms))
    return lists, 8 * B * k * (lists + -(-lists // 8))


def check_scan_args(what: str, d: int, k: int, d_multiple: int) -> None:
    """What the B1/B6 kernels refuse: k past MAX_K, d not a multiple of
    ``d_multiple`` (the elements of one 16-byte copy)."""
    if k > MAX_K:
        raise ValueError(f"{what}: the kernel takes k <= {MAX_K}, got {k}")
    if d % d_multiple:
        raise ValueError(f"{what}: the kernel takes d % {d_multiple} == 0, got d={d}")


def launch_scan(entry: str, tensors, B: int, N: int, d: int, k: int):
    """Allocate the scratch and outputs and launch ``entry`` of
    ``csrc/dense_topk.cu`` on (q, rows[, scales]) -> (scores, ids)."""
    lib = _build.library("dense_topk")
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * (len(tensors) + 3) + [i] * 5 + [p]
        fn.restype = i
    dev = tensors[0].device
    sms = _sms.get(dev.index)
    if sms is None:
        sms = _sms[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    lists, nbytes = scan_scratch(B, N, k, sms)
    partial = torch.empty((nbytes // 8,), dtype=torch.int64, device=dev)
    scores = torch.empty((B, k), dtype=torch.float32, device=dev)
    ids = torch.empty((B, k), dtype=torch.int32, device=dev)
    rc = fn(*(t.data_ptr() for t in tensors), partial.data_ptr(), scores.data_ptr(),
            ids.data_ptr(), B, N, d, k, lists, _build.stream_ptr(dev))
    _build.check(rc, entry)
    return scores, ids


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
    check_scan_args("dense_topk", d, k, 4)
    _build.check_kernel_inputs("dense_topk", torch.float32, queries, kb)
    out = launch_scan("dense_topk_launch", (queries, kb), B, N, d, k)
    launches += 1
    return out
