"""KNN-LM serving (paper §5.3; the port's ``repro.core.knnlm``): retrieval for
*every* generated token, next-token distribution interpolated between the LM and
a k-NN datastore.

RaLMSpec adaptations (paper §5.3):
  * cache-update rule: populate the cache with the next ``n`` datastore entries
    *after* each retrieved entry (spatial locality of consecutive training
    positions), instead of re-inserting the same entry;
  * relaxed verification: a speculative step is correct iff the *decoded token*
    matches the ground-truth decoded token (token-match equivalence) — matching all
    k neighbour sets exactly would be exponentially unlikely, matching the
    argmax of the interpolated distribution is both sufficient for output
    preservation and achievable.

Datastore scans delegate to the retrieval-backend layer: the retriever handed
in here is an :class:`~repro_torch.retrieval.retrievers.ExactDenseRetriever`
(or IVF) over the KNN datastore, so the per-token scan executes on whichever
backend it was built with — flat numpy, or the CUDA dense top-k (EDR) and
gathered top-k (ADR) with the datastore resident on the device. Nothing in
this module special-cases the execution strategy.

:func:`knn_interpolate` runs in numpy float64 on the host, as in the
reference, so that its argmax is the reference's bit for bit given the same
logits, values and scores.
"""
from __future__ import annotations

import time
from typing import Sequence

import numpy as np

from repro_torch.configs.base import RaLMConfig
from repro_torch.core.cache import DenseRetrievalCache
from repro_torch.core.ralmspec import ServeResult
from repro_torch.core.scheduler import OS3
from repro_torch.retrieval.encoder import ContextEncoder


def knn_interpolate(lm_logits: np.ndarray, values: np.ndarray, scores: np.ndarray,
                    lam: float, beta: float = 8.0) -> int:
    """argmax of (1-lam)*softmax(lm) + lam*p_knn, p_knn = softmax(beta*scores) mass
    scattered onto each neighbour's target token. Deterministic given inputs."""
    V = lm_logits.shape[-1]
    x = lm_logits.astype(np.float64)
    x = x - x.max()
    p_lm = np.exp(x)
    p_lm /= p_lm.sum()
    valid = values >= 0
    p_knn = np.zeros(V, np.float64)
    if valid.any():
        s = scores[valid].astype(np.float64) * beta
        s = np.exp(s - s.max())
        s /= s.sum()
        np.add.at(p_knn, values[valid], s)
    p = (1.0 - lam) * p_lm + lam * p_knn
    return int(np.argmax(p))


def spatial_insert(kb, cache, ids_row, next_n: int) -> None:
    """Paper §5.3 cache rule: insert the next-n entries *after* each retrieved
    datastore position (consecutive entries are consecutive training
    positions — spatial locality). Shared by KNNLMSpec and the fleet's
    KNN-LM workload."""
    want = []
    for did in ids_row:
        did = int(did)
        if did >= 0:
            want.extend(range(did, min(did + next_n + 1, kb.size)))
    want = [w for w in dict.fromkeys(want) if w not in cache]
    if want:
        cache.insert(want, kb.embeddings[want], kb.values[want])


class KNNLMBase:
    def __init__(self, engine, retriever, rcfg: RaLMConfig, encoder: ContextEncoder):
        self.engine = engine
        self.retriever = retriever
        self.rcfg = rcfg
        self.encoder = encoder
        self.kb = retriever.kb
        if getattr(self.kb, "values", None) is None:
            raise ValueError(
                "KNN-LM serving needs a value-carrying datastore "
                "(DenseKB from build_knn_datastore); got a KB without "
                "per-entry values")

    def _query(self) -> np.ndarray:
        return self.encoder.encode(self.engine.tokens)

    def _done(self) -> bool:
        return (self.engine.finished
                or len(self.engine.generated) >= self.rcfg.max_new_tokens)


class KNNLMSeq(KNNLMBase):
    """Baseline: one KB retrieval per generated token (Khandelwal et al. 2019)."""

    def serve(self, prompt: Sequence[int]) -> ServeResult:
        eng, r, rcfg = self.engine, self.retriever, self.rcfg
        eng.stats.reset()
        r0t, r0c, r0q = r.stats.time, r.stats.calls, r.stats.queries
        r0m = r.stats.modeled_time
        t0 = time.perf_counter()
        eng.start(list(prompt)[-rcfg.max_prompt_len:])
        while not self._done():
            q = self._query()
            ids, sc = r.retrieve(q[None], rcfg.knn_k)
            vals = self.kb.values[ids[0]]
            tok = knn_interpolate(eng.peek_logits(), vals, sc[0], rcfg.knn_lambda)
            eng.advance(tok)
        wall = time.perf_counter() - t0
        measured_r = r.stats.time - r0t
        return ServeResult(tokens=list(eng.generated), wall_time=wall,
                           analytic_time=wall - measured_r
                           + (r.stats.modeled_time - r0m),
                           gen_time=eng.stats.gen_time,
                           retrieval_time=measured_r,
                           kb_calls=r.stats.calls - r0c,
                           kb_queries=r.stats.queries - r0q)


class KNNLMSpec(KNNLMBase):
    """Speculative KNN-LM serving with the modified cache-update + verification."""

    def serve(self, prompt: Sequence[int]) -> ServeResult:
        eng, r, rcfg = self.engine, self.retriever, self.rcfg
        eng.stats.reset()
        r0t, r0c, r0q = r.stats.time, r.stats.calls, r.stats.queries
        os3 = OS3(window=rcfg.os3_window, gamma_max=rcfg.gamma_max,
                  max_stride=rcfg.max_stride) if rcfg.use_os3 else None
        res = ServeResult(tokens=[], wall_time=0, analytic_time=0, gen_time=0,
                          retrieval_time=0, kb_calls=0, kb_queries=0)
        t0 = time.perf_counter()
        analytic = 0.0

        eng.start(list(prompt)[-rcfg.max_prompt_len:])
        cache = DenseRetrievalCache(self.kb.embeddings.shape[1],
                                    rcfg.cache_capacity)
        q0 = self._query()
        ids0, _ = r.retrieve(q0[None], rcfg.knn_k)
        analytic += r.stats.model_latency(1)
        spatial_insert(self.kb, cache, ids0[0], rcfg.knn_prefetch_next_n)

        while not self._done():
            stride = os3.stride if os3 else rcfg.speculation_stride
            snaps, queries, lm_logits, spec_toks, a_times = [], [], [], [], []
            while len(spec_toks) < max(stride, 1) and not self._done():
                ta = time.perf_counter()
                snaps.append(eng.snapshot())
                q = self._query()
                ids, sc = cache.retrieve(q, rcfg.knn_k)
                vals = np.where(ids >= 0, self.kb.values[np.maximum(ids, 0)], -1)
                logits = eng.peek_logits()
                tok = knn_interpolate(logits, vals, sc, rcfg.knn_lambda)
                eng.advance(tok)
                a = time.perf_counter() - ta
                queries.append(q)
                lm_logits.append(logits)
                spec_toks.append(tok)
                a_times.append(a)
                analytic += a
                if os3:
                    os3.record_speculation(a)
            if not spec_toks:
                break
            res.spec_steps += len(spec_toks)
            res.strides.append(len(spec_toks))

            tb = time.perf_counter()
            gt_ids, gt_sc = r.retrieve(np.stack(queries), rcfg.knn_k)
            b_lat = time.perf_counter() - tb
            b_model = r.stats.model_latency(len(queries))
            analytic += b_model

            m = len(spec_toks)
            for i in range(len(spec_toks)):
                gt_vals = self.kb.values[gt_ids[i]]
                gt_tok = knn_interpolate(lm_logits[i], gt_vals, gt_sc[i],
                                         rcfg.knn_lambda)
                if gt_tok != spec_toks[i]:
                    m = i
                    gt_correct = gt_tok
                    break
            for i in range(len(spec_toks)):
                spatial_insert(self.kb, cache, gt_ids[i],
                               rcfg.knn_prefetch_next_n)
            if os3:
                os3.record_verification(b_model, len(spec_toks), m)
            res.rounds += 1

            if m < len(spec_toks):
                res.mismatches += 1
                eng.restore(snaps[m])
                tc = time.perf_counter()
                eng.advance(gt_correct)
                analytic += time.perf_counter() - tc

        res.tokens = list(eng.generated)
        res.wall_time = time.perf_counter() - t0
        res.analytic_time = analytic
        res.gen_time = eng.stats.gen_time
        res.retrieval_time = r.stats.time - r0t
        res.kb_calls = r.stats.calls - r0c
        res.kb_queries = r.stats.queries - r0q
        return res
