"""B4, B5, B7, B8: the ADR probe's gathered scans (``csrc/gathered_topk.cu``).

Counterparts of ``repro.kernels.dense_topk``'s ``fused_gathered_topk_pallas``
(B4), ``gathered_topk_pallas`` (B5), ``quant_fused_gathered_topk_pallas`` (B7)
and ``quant_gathered_topk_pallas`` (B8). Query b scores only the rows named in
``cand[b]`` ((B, C) int32, ids sorted ascending, -1 pads) and keeps the top k
of its row: score descending, then candidate column ascending (the order of
the Pallas merge, which is id order for the backends' id-sorted rows). Pad
slots, and slots past C when k > C, come back as (NEG, -1). The fused scans
read no KB row at or past N: such an id scores NEG, as a pad does, and keeps
its id.

The four differ only in where a row comes from and in its element type: the
resident KB by id (``fused_*``: B4, B7) or a pre-gathered (B, C, d) slab (B5,
B8); fp32 rows, or int8 codes whose per-row fp32 scale multiplies the finished
score (``quant_*``: B7, B8). Each wrapper runs the CUDA kernel on CUDA tensors
and its plain PyTorch version (``*_plain``) on CPU tensors. ``launches``
counts kernel launches per wrapper. The kernels take any d (q and rows
zero-padded to a multiple of 4 fp32 or 16 int8 elements) and any k >= 1
(k > 256: a key pass and a select pass); their scratch is
``dense_topk.scan_scratch(..., per_query=True)``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dense_topk import NEG, launch, pad_d

launches = dict.fromkeys(("fused_gathered_topk", "gathered_topk",
                          "quant_fused_gathered_topk", "quant_gathered_topk"), 0)


def _topk_of_scores(s: torch.Tensor, cand: torch.Tensor, k: int, real=None):
    """Scores (B, C) -> the top k: columns that are not ``real`` (default:
    pads, cand < 0) to NEG, a stable descending sort over columns (ties keep
    column order), ids from ``cand``, and (NEG, -1) for pads and for slots
    past C."""
    B, C = s.shape
    s = s.masked_fill(~real if real is not None else cand < 0, NEG)
    scores, pos = torch.sort(s, dim=1, descending=True, stable=True)
    ids = torch.gather(cand.long(), 1, pos).clamp(min=-1)
    scores, ids = scores[:, :k], ids[:, :k]
    if k > C:
        scores = torch.cat([scores, scores.new_full((B, k - C), NEG)], 1)
        ids = torch.cat([ids, ids.new_full((B, k - C), -1)], 1)
    return scores.contiguous(), ids.to(torch.int32)


def gathered_topk_plain(queries, emb, cand, k: int):
    """B5's plain version: fp32 einsum over the slab emb (B, C, d)."""
    s = torch.einsum("bd,bcd->bc", queries.float(), emb.float())
    return _topk_of_scores(s, cand, k)


def _in_kb(cand, n_rows: int):
    """The KB rows a fused scan reads: ids in [0, N), clamped into range for
    the gather (the rest are masked)."""
    return (cand >= 0) & (cand < n_rows), cand.clamp(0, n_rows - 1).long()


def fused_gathered_topk_plain(queries, kb, cand, k: int):
    """B4's plain version: gather kb's rows by id, then score as B5's."""
    real, idx = _in_kb(cand, kb.shape[0])
    s = torch.einsum("bd,bcd->bc", queries.float(), kb[idx].float())
    return _topk_of_scores(s, cand, k, real)


def quant_gathered_topk_plain(queries, emb, scl, cand, k: int):
    """B8's plain version: fp32 einsum over the cast codes (B, C, d), then
    the scale slab (B, C) on the scores."""
    s = torch.einsum("bd,bcd->bc", queries.float(), emb.float()) * scl.float()
    return _topk_of_scores(s, cand, k)


def quant_fused_gathered_topk_plain(queries, codes, scales, cand, k: int):
    """B7's plain version: gather codes and scales by id, then score as
    B8's."""
    real, idx = _in_kb(cand, codes.shape[0])
    s = torch.einsum("bd,bcd->bc", queries.float(), codes[idx].float()) * scales[idx].float()
    return _topk_of_scores(s, cand, k, real)


def _scan(name: str, queries, rows, scales, cand, k: int, row_dtype, plain):
    """The body every wrapper shares: checks, then the plain version for CPU
    tensors or the kernel for CUDA tensors."""
    if queries.ndim != 2 or cand.ndim != 2 or cand.shape[0] != queries.shape[0] \
            or rows.shape[-1] != queries.shape[1]:
        raise ValueError(f"{name}: shapes q {tuple(queries.shape)}, rows "
                         f"{tuple(rows.shape)}, cand {tuple(cand.shape)}")
    if k < 1:
        raise ValueError(f"{name}: k={k} < 1")
    tensors = [queries, rows, cand] + ([] if scales is None else [scales])
    if _build.on_cpu(name, *tensors):
        return plain()
    B, C = cand.shape
    _build.check_kernel_inputs(name, torch.float32, queries,
                               *([] if scales is None else [scales]))
    _build.check_kernel_inputs(name, row_dtype, rows)
    _build.check_kernel_inputs(name, torch.int32, cand)
    vec = 16 // rows.element_size()          # elements per 16-byte copy
    queries, rows = pad_d(queries, vec), pad_d(rows, vec)
    d = queries.shape[1]
    fused = name.startswith(("fused", "quant_fused"))
    sizes = (B, rows.shape[0], C, d, k) if fused else (B, C, d, k)
    ins = [t for t in (queries, rows, scales, cand) if t is not None]
    out = launch("gathered_topk", f"{name}_launch", ins, sizes, B, C, k, per_query=True)
    launches[name] += 1
    return out


def fused_gathered_topk(queries, kb, cand, k: int):
    """B4: queries (B, d) f32, kb (N, d) f32 resident, cand (B, C) int32
    -> (scores (B, k) f32, ids (B, k) int32)."""
    if kb.ndim != 2:
        raise ValueError(f"fused_gathered_topk: kb {tuple(kb.shape)} is not (N, d)")
    return _scan("fused_gathered_topk", queries, kb, None, cand, k, torch.float32,
                 lambda: fused_gathered_topk_plain(queries, kb, cand, k))


def gathered_topk(queries, emb, cand, k: int):
    """B5: queries (B, d) f32, emb (B, C, d) f32 pre-gathered, cand (B, C)
    int32 -> (scores (B, k) f32, ids (B, k) int32)."""
    if emb.shape[:2] != cand.shape or emb.ndim != 3:
        raise ValueError(f"gathered_topk: emb {tuple(emb.shape)} is not cand's "
                         f"{tuple(cand.shape)} x d")
    return _scan("gathered_topk", queries, emb, None, cand, k, torch.float32,
                 lambda: gathered_topk_plain(queries, emb, cand, k))


def quant_fused_gathered_topk(queries, codes, scales, cand, k: int):
    """B7: queries (B, d) f32, codes (N, d) int8 and scales (N,) f32
    resident, cand (B, C) int32 -> (scores (B, k) f32, ids (B, k) int32)."""
    if codes.ndim != 2 or scales.shape != codes.shape[:1]:
        raise ValueError(f"quant_fused_gathered_topk: codes {tuple(codes.shape)}, "
                         f"scales {tuple(scales.shape)}")
    return _scan("quant_fused_gathered_topk", queries, codes, scales, cand, k, torch.int8,
                 lambda: quant_fused_gathered_topk_plain(queries, codes, scales, cand, k))


def quant_gathered_topk(queries, emb, scl, cand, k: int):
    """B8: queries (B, d) f32, emb (B, C, d) int8 and scl (B, C) f32
    pre-gathered, cand (B, C) int32 -> (scores (B, k) f32, ids (B, k) int32)."""
    if emb.ndim != 3 or emb.shape[:2] != cand.shape or scl.shape != cand.shape:
        raise ValueError(f"quant_gathered_topk: emb {tuple(emb.shape)}, scl "
                         f"{tuple(scl.shape)}, cand {tuple(cand.shape)}")
    return _scan("quant_gathered_topk", queries, emb, scl, cand, k, torch.int8,
                 lambda: quant_gathered_topk_plain(queries, emb, scl, cand, k))
