"""B1: the EDR full scan with a canonical top-k (``csrc/dense_topk.cu``).

Counterpart of ``repro.kernels.dense_topk.dense_topk_pallas``: queries (B, d)
f32 against a KB (N, d) f32 -> (scores (B, k) f32, ids (B, k) int32), rows in
the canonical order (score descending, then id ascending), which is the order
``repro.retrieval.backends.canonical_topk`` and the Pallas merge produce.

:func:`dense_topk` runs the CUDA kernel on CUDA tensors and the plain PyTorch
version (:func:`dense_topk_plain`) on CPU tensors. ``launches`` counts kernel
launches. The kernel takes any d (queries and KB zero-padded by
:func:`pad_d` to a multiple of 4) and any k <= N (k > MAX_K: a key pass and
a select pass). :func:`scan_scratch` and :func:`launch` serve every scan
wrapper (B1, B6 and the gathered B4, B5, B7, B8).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG = -3.4e38          # pad sentinel of the kernel (score), with id -1
MAX_K = 256            # largest k of the fast path (per-CTA lists); above it
                       # the key pass and the select pass (kMaxK in scan.cuh)
launches = 0


def dense_topk_plain(queries: torch.Tensor, kb: torch.Tensor, k: int):
    """One fp32 product and a stable descending sort: ties keep their id
    order, so equal scores come out id-ascending."""
    s = queries.float() @ kb.float().T
    scores, ids = torch.sort(s, dim=1, descending=True, stable=True)
    return scores[:, :k].contiguous(), ids[:, :k].to(torch.int32)


TILE_ROWS = 256        # columns per tile of the scan (kTileRows in scan.cuh)
GATHER_CTAS_PER_SM = 2     # a gathered scan's CTAs per SM (kGatherCtas in gathered_topk.cu)
GATHER_CTA_TILES = 2       # a gathered scan's tiles per CTA, at most, when B > 1
SELECT_SMEM_KEYS = 16384   # a select pass sorts up to this many keys in shared memory
_sms: dict = {}


def pad_d(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """``x`` with its last dimension zero-padded up to a multiple of
    ``multiple`` (``x`` itself when it is one already). The scans copy rows
    in 16-byte vectors (4 fp32 or 16 int8 elements), so queries and rows are
    padded alike; a zero pair adds exactly 0 to an fmaf chain, so every
    score keeps its value."""
    extra = -x.shape[-1] % multiple
    return x if not extra else torch.nn.functional.pad(x, (0, extra))


def scan_scratch(B: int, ncols: int, k: int, sms: int, per_query: bool = False):
    """(lists, bytes) of one scan call over ``ncols`` columns per query on a
    card with ``sms`` SMs, computed without the library. ``lists``, the
    scan's CTAs per query block: one per SM for a full scan (B1, B6); for a
    gathered scan (``per_query``: B4, B5, B7, B8), whose CTAs each serve one
    query, two to an SM, at least the 2 x sms CTAs shared among the B
    queries and at most two 256-column tiles per CTA (queries hold different
    numbers of real candidates: short CTAs let the CTA scheduler balance
    them); and none without a tile. For k <= MAX_K each CTA writes one
    partial list of k sort keys (8 bytes) per query, and the merge levels
    take room for ceil(lists / 8) more; above it the key pass writes every
    column's key, and a top k of more than SELECT_SMEM_KEYS keys (rounded up
    to a power of two) is sorted in device memory beside them."""
    tiles = -(-ncols // TILE_ROWS)
    share = max(GATHER_CTAS_PER_SM * sms // B, -(-tiles // GATHER_CTA_TILES)) \
        if per_query else sms
    lists = max(1, min(tiles, share, 65535))      # a gathered grid's y extent
    if k <= MAX_K:
        return lists, 8 * B * k * (lists + -(-lists // 8))
    P = 1 << (min(k, ncols) - 1).bit_length()
    return lists, 8 * B * (ncols + (P if P > SELECT_SMEM_KEYS else 0))


def sm_count(device) -> int:
    """The SM count of a CUDA device (read once per device)."""
    sms = _sms.get(device.index)
    if sms is None:
        sms = _sms[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return sms


def launch(lib: str, entry: str, tensors, sizes, B: int, ncols: int, k: int,
           per_query: bool = False):
    """Allocate the scratch and outputs and launch ``entry`` of
    ``csrc/<lib>.cu`` on ``tensors`` (inputs, then the scratch and outputs
    follow) with the int ``sizes``, then ``lists``, then the stream
    -> (scores (B, k), ids (B, k))."""
    fn = getattr(_build.library(lib), entry)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * (len(tensors) + 3) + [i] * (len(sizes) + 1) + [p]
        fn.restype = i
    dev = tensors[0].device
    lists, nbytes = scan_scratch(B, ncols, k, sm_count(dev), per_query)
    partial = torch.empty((nbytes // 8,), dtype=torch.int64, device=dev)
    scores = torch.empty((B, k), dtype=torch.float32, device=dev)
    ids = torch.empty((B, k), dtype=torch.int32, device=dev)
    rc = fn(*(t.data_ptr() for t in tensors), partial.data_ptr(), scores.data_ptr(),
            ids.data_ptr(), *sizes, lists, _build.stream_ptr(dev))
    _build.check(rc, entry)
    return scores, ids


def dense_topk(queries: torch.Tensor, kb: torch.Tensor, k: int):
    """queries (B, d), kb (N, d) -> (scores (B, k) f32, ids (B, k) int32)."""
    global launches
    if queries.ndim != 2 or kb.ndim != 2 or queries.shape[1] != kb.shape[1]:
        raise ValueError(f"dense_topk: shapes {tuple(queries.shape)} x "
                         f"{tuple(kb.shape)}")
    B = queries.shape[0]
    N = kb.shape[0]
    if not 1 <= k <= N:
        raise ValueError(f"dense_topk: k={k} outside [1, N={N}]")
    if _build.on_cpu("dense_topk", queries, kb):
        return dense_topk_plain(queries, kb, k)
    _build.check_kernel_inputs("dense_topk", torch.float32, queries, kb)
    queries, kb = pad_d(queries, 4), pad_d(kb, 4)
    out = launch("dense_topk", "dense_topk_launch", (queries, kb),
                 (B, N, kb.shape[1], k), B, N, k)
    launches += 1
    return out
