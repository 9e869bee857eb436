"""The plain reference's retrieval: the context encoder's queries, an exact
blocked top-k scan over the KB, and KNN-LM's interpolation. Imports nothing
of the program.

The queries follow the port's context encoder: the recency-weighted sum of
the last ``window`` tokens' table rows (the last token weight 1, each
earlier one ``decay`` times the next), L2-normalised. The scan scores every
KB row in float32 (``prec``: IEEE, or the TF32 control) and keeps the best
``k`` of each query, block by block, so the KB never needs to sit on the
device whole.
"""
from __future__ import annotations

import numpy as np
import torch

from bench.reference.model import mm, precision


def encode(table: np.ndarray, tokens, window: int, decay: float) -> np.ndarray:
    """The query (d,) float32 of a context (a list of ints)."""
    toks = np.asarray(tokens, np.int64)[-window:]
    w = decay ** np.arange(len(toks) - 1, -1, -1, dtype=np.float64)
    v = (table[toks].astype(np.float64) * w[:, None]).sum(0)
    n = np.linalg.norm(v)
    return (v / n if n > 0 else v).astype(np.float32)


def topk_scan(keys: np.ndarray, queries: np.ndarray, k: int, device,
              precs=("fp32",), block_bytes: int = 1 << 30) -> dict:
    """Exact top-k of each query over every row of ``keys`` (N, d), host.
    -> {prec: (scores (B, k) float32 descending, ids (B, k) int64)}, one
    scan per arithmetic in ``precs`` over one upload of each block."""
    q = torch.as_tensor(np.ascontiguousarray(queries, np.float32), device=device)
    B, (N, d) = q.shape[0], keys.shape
    rows = max(k, min(N, block_bytes // (4 * max(B, d))))
    best = {p: (torch.full((B, 0), float("-inf"), device=device),
                torch.zeros((B, 0), dtype=torch.int64, device=device)) for p in precs}
    for lo in range(0, N, rows):
        hi = min(lo + rows, N)
        blk = torch.as_tensor(keys[lo:hi], device=device)
        for p in precs:
            with precision(p, device):
                s = mm(q, blk.T, p)
            kk = min(k, hi - lo)
            sc, ix = torch.topk(s, kk, dim=1)
            ss, ii = best[p]
            ss, ii = torch.cat([ss, sc], 1), torch.cat([ii, ix + lo], 1)
            top = torch.topk(ss, min(k, ss.shape[1]), dim=1)
            best[p] = (top.values, torch.gather(ii, 1, top.indices))
    return {p: (s.cpu().numpy(), i.cpu().numpy()) for p, (s, i) in best.items()}


def exact_scores(keys: np.ndarray, queries: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Each query's float64 score against each of its ids (B, k)."""
    rows = keys[np.clip(ids, 0, len(keys) - 1)].astype(np.float64)     # (B, k, d)
    return np.einsum("bkd,bd->bk", rows, queries.astype(np.float64))


def interpolate_logp(lm_logits: np.ndarray, values: np.ndarray, scores: np.ndarray,
                     lam: float, beta: float = 8.0) -> np.ndarray:
    """log of KNN-LM's next-token distribution, float64: (1 - lam) times the
    LM's softmax plus lam times the neighbours' softmax(beta * score) mass on
    each neighbour's value token."""
    x = lm_logits.astype(np.float64)
    p = np.exp(x - x.max())
    p *= (1.0 - lam) / p.sum()
    s = scores.astype(np.float64) * beta
    w = np.exp(s - s.max())
    np.add.at(p, values.astype(np.int64), lam * w / w.sum())
    with np.errstate(divide="ignore"):
        return np.log(p)
