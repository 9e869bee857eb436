"""What decides ``correct``: the served path's own outputs against the plain
reference, after the window has closed and the program's state is freed.

Three numbers, each with a limit of its own (``limits/<cell>.json``):

  * ``token_miss``: over a sample of the finished requests drawn from the
    seed (the longest one always in it, some hundreds of served tokens), the
    served tokens that lie below the reference's best at their position by
    more than a tie: 4 times the ``logit_err`` limit, the most by which
    logits within that limit can reorder two tokens (RaLM: LM logits under
    the passage the reference retrieves; KNN-LM: nats of the interpolated
    distribution). An exact count, limit 0. Greedy tokens move only where
    two tokens nearly tie, so a precision too low shows in ``logit_err``
    long before it moves a token; this count catches a token or a passage
    that is wrong outright.
  * ``logit_err``: over a sample of the logits the model handed on in the
    window, of each kind (``prefill``: a prefill's last logits; ``step``:
    decode steps' logits through the ring cache, as KNN-LM reads them for
    interpolation and as RaLM's engine holds them after a stride), the
    largest |program - reference| at the same context.
  * ``kb_err``: over a sample of the window's merged KB calls (B1), the
    largest gap between the program's scores and the reference's exact
    top-k scores of the same queries, and between each returned score and
    the exact score of the returned id (an id that is not a KB row, or
    repeats in a row, reads infinite).

A number with nothing to read (no logits of a kind or no KB call sampled:
the program no longer hands them on where the benchmark reads them) reads
infinite: the run is not correct until a benchmark change reads them
where they now are.

The control (``ctrl="tf32"``) reads the same three numbers with the
reference in TF32 put in the program's place.
"""
from __future__ import annotations

import numpy as np

from bench.reference import loops
from bench.reference.retrieval import exact_scores

TIE = 1e-5            # float32 rounding of a tie in a unit-vector dot product
TARGET_TOKENS = 380   # served tokens the sampled requests hold at least


def sample_requests(requests: list, seed: int, target: int = TARGET_TOKENS) -> list:
    """The longest finished request, then others in an order drawn from the
    seed, until the sample holds ``target`` served tokens."""
    if not requests:
        return []
    rng = np.random.default_rng([seed, 0x1D6E])
    longest = max(range(len(requests)),
                  key=lambda i: len(requests[i]["prompt"]) + len(requests[i]["tokens"]))
    order = [longest] + [int(i) for i in rng.permutation(len(requests)) if i != longest]
    out, n = [], 0
    for i in order:
        out.append(requests[i])
        n += len(requests[i]["tokens"])
        if n >= target:
            break
    return out


def _kb_error(keys: np.ndarray, q, k, ids, scores, ref_scores) -> float:
    ids = np.asarray(ids, np.int64)
    scores = np.asarray(scores, np.float64)
    if ids.shape != (len(q), min(k, len(keys))) or ids.min() < 0 or ids.max() >= len(keys):
        return float("inf")
    if any(len(set(row.tolist())) < len(row) for row in ids):
        return float("inf")
    ranked = -np.sort(-scores, axis=1)
    e1 = np.abs(ranked - ref_scores[:, :ids.shape[1]]).max()
    e2 = np.abs(scores - exact_scores(keys, q, ids)).max()
    return float(max(e1, e2))


def readings(cfg: dict, corpus, requests: list, kb_calls: list, logit_records: dict,
             seed: int, device, tie_logit: float, ctrl: str = "") -> dict:
    """The three numbers (and with ``ctrl`` the control's three, prefixed
    ``ctrl_``) of one run, with ``token_gap``, the widest gap of a served
    token, beside them. ``tie_logit`` is the gap below which two tokens tie.
    The reference model is ``corpus.model``'s, the configuration's own."""
    knn, fwd = cfg["workload"] == "knnlm", corpus.model.forward
    sample = sample_requests(requests, seed)
    make_q = loops.knnlm_queries if knn else loops.ralm_queries
    judge_q = [make_q(r, cfg, corpus.table) for r in sample]
    k_scan = max([cfg["knn_k"] + 4 if knn else 4] + [c[1] for c in kb_calls])
    all_q = [q for qs in judge_q for q in qs] + [row for c in kb_calls for row in c[0]]
    found = loops.scan(corpus.keys, all_q, k_scan, device, ctrl) if all_q else {}
    out = {"token_miss": 0, "logit_err": 0.0, "kb_err": 0.0, "token_gap": 0.0}
    if ctrl:
        out.update(ctrl_token_miss=0, ctrl_logit_err=0.0, ctrl_kb_err=0.0, ctrl_token_gap=0.0)
    off = 0
    for req, qs in zip(sample, judge_q):
        part = {p: (s[off:off + len(qs)], i[off:off + len(qs)]) for p, (s, i) in found.items()}
        off += len(qs)
        if knn:
            g = loops.judge_knnlm(cfg, fwd, corpus.params, corpus.values, req, part, TIE, ctrl)
        else:
            g = loops.judge_ralm(cfg, fwd, corpus.params, corpus.passages, req, part, TIE, ctrl)
        for key, gaps in [("", g["gaps"])] + ([("ctrl_", g["ctrl_gaps"])] if ctrl else []):
            out[key + "token_miss"] += sum(1 for x in gaps if x > tie_logit)
            out[key + "token_gap"] = max([out[key + "token_gap"]] + gaps)
    for q, k, ids, scores in kb_calls:
        ref_s, _ = found["fp32"]
        ref = ref_s[off:off + len(q)]
        out["kb_err"] = max(out["kb_err"], _kb_error(corpus.keys, q, k, ids, scores, ref))
        if ctrl:
            cs, ci = found[ctrl]
            kk = min(k, len(corpus.keys))
            out["ctrl_kb_err"] = max(out["ctrl_kb_err"], _kb_error(
                corpus.keys, q, k, ci[off:off + len(q), :kk], cs[off:off + len(q), :kk], ref))
        off += len(q)
    rows = [r for kind in sorted(logit_records) for r in logit_records[kind]]
    le = loops.logit_errors(cfg, fwd, corpus.params, rows, ctrl)
    empty = not logit_records or not all(logit_records.values())
    out["logit_err"] = float("inf") if empty else le["err"]
    if not kb_calls:
        out["kb_err"] = float("inf")
    if ctrl:
        out["ctrl_logit_err"] = le["ctrl_err"]
    return out


def verdict(numbers: dict, limits: dict, attempted: int, failed: int,
            prefix: str = "") -> tuple:
    """-> (correct, checks): every number at or under its limit, and every
    request of the window served in full. ``prefix="ctrl_"`` judges the
    control's numbers."""
    checks = {name: {"value": numbers[prefix + name], "limit": lim["limit"]}
              for name, lim in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return bool(ok and attempted > 0 and failed == 0), checks
