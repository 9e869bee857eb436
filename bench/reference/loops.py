"""The plain reference's sequential loops, teacher-forced on served tokens.

Iterative RaLM (the port's ``RaLMSeq``): before every ``stride`` new tokens
the query of the context so far (prompt and served tokens, no passage)
retrieves the top passage, whose first ``chunk`` tokens are put in front of
the context in place of the last one; the next ``stride`` tokens are the
greedy ones after it. KNN-LM (``KNNLMSeq``): every token is the argmax of
the LM's softmax interpolated with the ``k`` nearest datastore entries'
values. Given a request's prompt and the tokens a program served, these
loops work out what the reference would have put at every position, with
its logits, in the reference's own arithmetic, and return the gap by which
each served token lies below the reference's best.

A retrieval whose best candidates lie within ``tie`` of each other (float32
rounding of a tie) may go either way: every such candidate is tried, and a
position takes the smallest gap over them.

``prec`` names the arithmetic of the reference; the control passes
``ctrl="tf32"`` to read, at the same positions, the gap of the token that the
TF32 reference puts first. Imports nothing of the program.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from bench.reference.model import forward
from bench.reference.retrieval import encode, interpolate_logp, topk_scan

MAX_VARIANTS = 16


def tied(scores: np.ndarray, n: int, tie: float) -> list:
    """The index sets of the ``n`` best of ``scores`` (descending) that
    float32 rounding of a tie at the boundary could have picked."""
    if n >= len(scores):
        return [tuple(range(len(scores)))]
    scores = np.asarray(scores, np.float64)
    edge = scores[n - 1]
    sure = [i for i in range(len(scores)) if scores[i] > edge + tie]
    amb = [i for i in range(len(scores)) if abs(scores[i] - edge) <= tie]
    need = n - len(sure)
    combos = itertools.islice(itertools.combinations(amb, need), MAX_VARIANTS)
    return [tuple(sure) + c for c in combos]


def chunk(passage, length: int) -> list:
    p = list(passage)[:length]
    return p + [1] * (length - len(p))


def ralm_queries(req: dict, rc: dict, table) -> list:
    P, T, s = req["prompt"], req["tokens"], rc["generation_stride"]
    return [encode(table, P + T[:r], rc["encoder_window"], rc["encoder_decay"])
            for r in range(0, len(T), s)]


def judge_ralm(cfg: dict, params: dict, passages, req: dict, found: dict,
               tie: float, ctrl: str = "") -> dict:
    """Gaps of one RaLM request. ``found`` maps each precision to the scan's
    (scores, ids) of this request's retrieval queries (``ralm_queries``
    order). -> {"gaps": each served token's gap, and with ``ctrl``
    "ctrl_gaps": the gap of the control's own token at each position}."""
    P, T, s = req["prompt"], req["tokens"], cfg["generation_stride"]
    L = cfg["passage_tokens"]
    sc32, id32 = found["fp32"]
    out = {"gaps": [], "ctrl_gaps": []}
    for i, r in enumerate(range(0, len(T), s)):
        end = min(r + s, len(T))
        best = None                  # per candidate: fp32 logits rows for T[r:end]
        for cand in tied(sc32[i], 1, tie):
            doc = chunk(passages[int(id32[i][cand[0]])], L)
            lg = forward(cfg, params, doc + P + T[:end])[len(doc) + len(P) + r - 1:
                                                          len(doc) + len(P) + end - 1]
            lg = lg.double().cpu().numpy()
            gaps = lg.max(1) - lg[np.arange(end - r), T[r:end]]
            if best is None or gaps.max() < best[0].max():
                best = (gaps, lg)
        out["gaps"] += best[0].tolist()
        if ctrl:
            scc, idc = found[ctrl]
            doc = chunk(passages[int(idc[i][0])], L)
            lc = forward(cfg, params, doc + P + T[:end], ctrl)[
                len(doc) + len(P) + r - 1:len(doc) + len(P) + end - 1]
            pick = lc.argmax(1).cpu().numpy()
            lg = best[1]
            out["ctrl_gaps"] += (lg.max(1) - lg[np.arange(end - r), pick]).tolist()
    return out


def knnlm_queries(req: dict, rc: dict, table) -> list:
    P, T = req["prompt"], req["tokens"]
    return [encode(table, P + T[:j], rc["encoder_window"], rc["encoder_decay"])
            for j in range(len(T))]


def judge_knnlm(cfg: dict, params: dict, values, req: dict, found: dict, tie: float,
                ctrl: str = "") -> dict:
    """Gaps of one KNN-LM request, in the log of the interpolated
    distribution (nats); ``found`` as in :func:`judge_ralm`, over
    ``knnlm_queries``."""
    P, T = req["prompt"], req["tokens"]
    k, lam = cfg["knn_k"], cfg["knn_lambda"]
    n = len(T)
    ctx = P + T[:n - 1]
    lm = forward(cfg, params, ctx)[len(P) - 1:].double().cpu().numpy()
    lmc = (forward(cfg, params, ctx, ctrl)[len(P) - 1:].double().cpu().numpy()
           if ctrl else None)
    sc32, id32 = found["fp32"]
    out = {"gaps": [], "ctrl_gaps": []}
    for j in range(n):
        logps = [interpolate_logp(lm[j], values[id32[j][list(c)]], sc32[j][list(c)], lam)
                 for c in tied(sc32[j], k, tie)]
        out["gaps"].append(min(float(lp.max() - lp[T[j]]) for lp in logps))
        if ctrl:
            scc, idc = found[ctrl]
            pick = int(np.argmax(interpolate_logp(lmc[j], values[idc[j][:k]], scc[j][:k], lam)))
            out["ctrl_gaps"].append(min(float(lp.max() - lp[pick]) for lp in logps))
    return out


def logit_errors(cfg: dict, params: dict, records: list, ctrl: str = "") -> dict:
    """Largest |program logit - reference logit| over the captured (context,
    logits) records, and with ``ctrl`` the control's |TF32 - fp32|."""
    out = {"err": 0.0, "ctrl_err": 0.0}
    for ctx, logits in records:
        ref = forward(cfg, params, ctx)[-1]
        prog = torch.as_tensor(logits, device=ref.device)
        out["err"] = max(out["err"], float((prog - ref).abs().max()))
        if ctrl:
            c = forward(cfg, params, ctx, ctrl)[-1]
            out["ctrl_err"] = max(out["ctrl_err"], float((c - ref).abs().max()))
    return out


def scan(keys, queries: list, k: int, device, ctrl: str = "") -> dict:
    """One exact scan of every query -> {prec: (scores, ids)}."""
    precs = ("fp32", ctrl) if ctrl else ("fp32",)
    return topk_scan(keys, np.stack(queries), k, device, precs)
