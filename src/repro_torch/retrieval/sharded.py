"""Dense retrieval over a KB cut into shards: the port's counterpart of
``repro.retrieval.sharded`` (``sharded_dense_topk`` and
``sharded_gathered_topk``), the multi-device form of the paper's batched
verification.

**Single controller, as in the reference.** The reference runs one process
that drives every shard through ``shard_map`` over a device mesh. The port
does the same over an explicit list of devices: shard s owns the contiguous
global ids ``[s * shard_n, (s + 1) * shard_n)`` as a tensor of its own on its
own device (:func:`shard_devices`: round-robin over the visible cards, all on
``cuda:0`` with one card, all on ``cpu`` for the CPU), and one search
launches one scan per shard (each shard's kernel: B1 or B6 for the full scan,
B4 or B7 for the ADR probe), moves each shard's ``(B, k_local)`` candidates
onto the queries' device, and merges them with one stable descending sort
over the shard-major columns (the reference's ``all_gather`` and its
replicated ``lax.top_k``, which run outside any Pallas kernel). One search
is one merged call however many shards answer it, so the fleet's
one-call-per-round invariant holds as it does on one device. A
multi-process form (one process per card, NCCL collectives) is not built:
one H100 cannot exercise NCCL across cards, and the single controller is
what the reference measures.

**Exactness.** Each shard's kernel scores a row as one ``fmaf`` chain over
d, whatever the shard's size, so a shard's rows carry the bytes the
unsharded scan gives them; within a shard the kernel's order is canonical
(score descending, id ascending), and across shards equal scores resolve to
the lower shard, which is the lower id, because the candidates concatenate
in shard order and the merge sort is stable. So the sharded result equals
the unsharded one byte for byte.

:func:`lower_sharded_retrieval` is the reference's dry-run artifact of the
same search: it builds the scan kernel and returns the plan, running
nothing.

**Padding.** ``shard_n = ceil(N / S)``: the last shard is short when S does
not divide N and may be empty (N = 9, S = 4). A shard takes its top
``k_local`` (dense: ``min(k, shard_n)``; gathered: ``min(k, C)``, since one
shard may own every candidate of a row); a short shard returns ``(NEG, -1)``
in the slots it cannot fill, which never beat a real row, and an empty shard
launches nothing.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import gathered_topk as GT
from repro_torch.kernels.dense_topk import NEG, dense_topk
from repro_torch.kernels.quant_topk import quant_dense_topk


def shard_devices(n_shards: Optional[int], device=None) -> List[torch.device]:
    """The device of each shard: round-robin over the visible cards when
    ``device`` is CUDA (``n_shards`` None or 0: one shard a card), every
    shard on ``device`` otherwise (``n_shards`` None or 0: one shard)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return [dev] * (n_shards or 1)
    cards = torch.cuda.device_count()
    return [torch.device("cuda", s % cards) for s in range(n_shards or cards)]


def shard_bounds(n_total: int, n_shards: int) -> List[Tuple[int, int]]:
    """``[lo, hi)`` of each shard's global ids: ``shard_n = ceil(N / S)``
    rows each, the last short or empty."""
    shard_n = -(-n_total // n_shards)
    return [(min(s * shard_n, n_total), min((s + 1) * shard_n, n_total))
            for s in range(n_shards)]


def on_device(device):
    """Make ``device`` the current CUDA device while a shard's scan is
    launched: the kernels launch on the current device (a no-op on the
    CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _pads(B: int, k: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.full((B, k), NEG, dtype=torch.float32, device=device),
            torch.full((B, k), -1, dtype=torch.int64, device=device))


def _fill(scores, ids, k: int):
    """(B, k') results widened to k columns with ``(NEG, -1)``."""
    B, kk = scores.shape
    if kk == k:
        return scores, ids
    ps, pi = _pads(B, k - kk, scores.device)
    return torch.cat([scores, ps], 1), torch.cat([ids, pi], 1)


def merge(parts: Sequence[Tuple[torch.Tensor, torch.Tensor]], k: int, device):
    """Each shard's ``(scores (B, k_local), global ids (B, k_local))``, in
    shard order, -> the top k of their concatenation: one stable descending
    sort, so equal scores keep shard order (the lower id)."""
    s = torch.cat([p[0].to(device) for p in parts], 1)
    i = torch.cat([p[1].to(device) for p in parts], 1)
    s, pos = torch.sort(s, dim=1, descending=True, stable=True)
    return s[:, :k].contiguous(), torch.gather(i, 1, pos[:, :k])


def sharded_dense_topk(queries: torch.Tensor, shards: Sequence[torch.Tensor], k: int, *,
                       n_total: int, scales: Optional[Sequence[torch.Tensor]] = None):
    """queries (B, d) f32; ``shards[s]`` the rows of shard s (fp32, or int8
    codes with ``scales[s]`` their per-row scales), padded alike in d ->
    (scores (B, k) f32, global ids (B, k) int64) on the queries' device, in
    the canonical order. ``k <= n_total``; each nonempty shard launches its
    scan once (B1, or B6 for int8)."""
    S = len(shards)
    if not 1 <= k <= n_total:
        raise ValueError(f"sharded_dense_topk: k={k} outside [1, N={n_total}]")
    bounds = shard_bounds(n_total, S)
    k_local = min(k, -(-n_total // S))
    B = queries.shape[0]
    parts = []
    for s, (lo, hi) in enumerate(bounds):
        rows = shards[s]
        if hi == lo:                                 # an empty shard: nothing to scan
            parts.append(_pads(B, k_local, queries.device))
            continue
        kk = min(k_local, hi - lo)
        with on_device(rows.device):
            q = queries.to(rows.device)
            if scales is None:
                sc, ids = dense_topk(q, rows, kk)
            else:
                sc, ids = quant_dense_topk(q, rows, scales[s], kk)
            parts.append(_fill(sc, ids.long() + lo, k_local))
    return merge(parts, k, queries.device)


def local_candidates(cand: torch.Tensor, lo: int, hi: int):
    """The candidates of ``cand`` (B, C) int, id-sorted rows with -1 pads
    last, that shard ``[lo, hi)`` owns, as shard-local ids compacted to the
    front of each row (still id-sorted, -1 pads last) and cut to the widest
    row's count -> (B, C_s) int32, or None where the shard owns none. A
    row's owned ids are one contiguous run of it, so the compaction keeps
    their order."""
    own = (cand >= lo) & (cand < hi)
    width = int(own.sum(1).max())
    if width == 0:
        return None
    order = torch.argsort((~own).to(torch.int8), dim=1, stable=True)[:, :width]
    local = torch.where(own, cand - lo, -1).gather(1, order)
    return local.to(torch.int32).contiguous()


def sharded_gathered_topk(queries: torch.Tensor, shards: Sequence[torch.Tensor],
                          cand: torch.Tensor, k: int, *, n_total: int,
                          scales: Optional[Sequence[torch.Tensor]] = None):
    """The ADR probe over the shards: queries (B, d) f32 and ``cand`` (B, C)
    global ids (id-sorted rows, -1 pads last) on the queries' device ->
    (scores (B, k') f32, global ids (B, k') int64), ``k' = min(k, C)``; pad
    slots come back as ``(NEG, -1)``. Each shard that owns a candidate
    launches its fused gathered scan once (B4, or B7 for int8) over its
    shard-local candidate rows."""
    B, C = cand.shape
    k_local = min(k, C)
    parts = []
    for s, (lo, hi) in enumerate(shard_bounds(n_total, len(shards))):
        rows = shards[s]
        local = local_candidates(cand, lo, hi)
        if local is None:                            # the shard owns no candidate
            parts.append(_pads(B, k_local, queries.device))
            continue
        with on_device(rows.device):
            q, local = queries.to(rows.device), local.to(rows.device)
            if scales is None:
                sc, ids = GT.fused_gathered_topk(q, rows, local, k_local)
            else:
                sc, ids = GT.quant_fused_gathered_topk(q, rows, scales[s], local, k_local)
            ids = ids.long()
            parts.append((sc, torch.where(ids >= 0, ids + lo, ids)))
    return merge(parts, k_local, queries.device)


def lower_sharded_retrieval(n_shards: int, *, n_docs: int = 1_048_576, d: int = 256,
                            batch: int = 8, k: int = 20, device=None) -> dict:
    """The sharded batched-verification search, built and planned but not
    run (the reference lowers and compiles it): on CUDA the B1 scan kernel
    is built and loaded; the plan says where each shard lives and what it
    holds -> {"shard_n", "k_local", "bounds" (each shard's
    ``[lo, hi)`` ids), "devices", "shard_bytes" (each shard's fp32 rows, d
    padded as the backends pad it), "batch", "k", "d"}."""
    devices = shard_devices(n_shards, device)
    if devices[0].type == "cuda":
        _build.library("dense_topk")
    bounds = shard_bounds(n_docs, n_shards)
    shard_n = -(-n_docs // n_shards)
    d_pad = -(-d // 4) * 4                       # dense_topk.pad_d's fp32 multiple
    return {"shard_n": shard_n, "k_local": min(k, shard_n),
            "bounds": bounds, "devices": [str(dv) for dv in devices],
            "shard_bytes": [(hi - lo) * d_pad * 4 for lo, hi in bounds],
            "batch": batch, "k": k, "d": d}
