"""Workload interface: the Algorithm-1 specifics of a fleet speculation round
(the port's ``repro.serving.workload``).

``FleetServer._run_round`` is a workload-GENERIC two-stage pipeline — lockstep
speculation sub-steps, ONE merged verification KB call (dedup'd, shared-cache
published, fault-guarded, optionally overlapped on the async worker), then a
per-slot split with rollback/carry — but WHAT a speculation sub-step does,
what the merged rows mean, and what "the speculation was right" means are
workload properties. This module is that seam:

  * :class:`IterativeRaLMWorkload` — the paper's iterative RaLM (Algorithm 1):
    a sub-step speculates a document from the cache (top-1), prepend-replaces
    it (re-prefill), and generates a stride; verification compares speculated
    DOC IDS against the KB top-1 (byte-parity equivalence, ``equivalence ==
    'byte'``); the cache-update rule inserts the verified top-k rows.
  * :class:`KNNLMWorkload` — KNN-LM serving (paper §5.3): every sub-step is
    one token — retrieve k neighbours from the cache, interpolate their value
    distribution with the LM logits
    (:func:`~repro_torch.core.knnlm.knn_interpolate`), and advance the batched
    engine one step; verification recomputes the token from the KB's
    ground-truth neighbours and the RECORDED logits (token-match equivalence,
    ``equivalence == 'token-match'``); the cache-update rule is the
    spatial-locality next-n insert (consecutive datastore entries are
    consecutive training positions).

Both workloads flow through the SAME merged KB call, shared cache tier, dedup
ledger, ``_retrieve_guarded`` fault shell, and async overlap machinery.
Workload instances are stateless (every hook takes the server as its first
argument), so one instance can serve any number of servers. Per-step
auxiliary state rides :attr:`repro_torch.core.ralmspec.RequestState.aux` (and
the 5th element of async carry tuples): iterative RaLM records ``None``;
KNN-LM records the LM logits captured at speculation time, which is what
makes overlapped (carried) KNN-LM steps verifiable a round later.
"""
from __future__ import annotations

import time
from typing import Dict, Sequence, Tuple

import numpy as np

from repro_torch import trace
from repro_torch.configs.base import RaLMConfig
from repro_torch.core.knnlm import knn_interpolate, spatial_insert
from repro_torch.core.ralmspec import first_mismatch


class Workload:
    """Strategy object for the fleet round loop's workload-specific steps.

    ``equivalence`` names the output-preservation contract the workload's
    verification enforces per slot: ``'byte'`` (outputs byte-identical to the
    sequential baseline) or ``'token-match'`` (KNN-LM's relaxed rule — the
    decoded token stream matches the baseline's, which is what "output" means
    for a language model, without requiring identical neighbour sets)."""

    name: str = "?"
    equivalence: str = "byte"

    def validate(self, srv) -> None:
        """Raise ValueError if the server's retriever/KB cannot run this
        workload (called once at server construction)."""

    def verify_k(self, rcfg: RaLMConfig) -> int:
        """Rows per query in the merged verification/seed KB call."""
        raise NotImplementedError

    def speculate_step(self, srv, doers: Sequence[int], states) -> Tuple[Dict, float]:
        """One lockstep speculation sub-step over ``doers``. Returns
        ``({slot: (snap, query, spec, aux)}, wall_seconds)`` where ``spec``
        is whatever verification will check (a doc id, a token) and ``aux``
        is the workload's per-step record (None if it needs none)."""
        raise NotImplementedError

    def build_verification_queries(self, st) -> Sequence:
        """The slot's contribution to the round's merged verification KB call
        — by default the queries its speculation sub-steps recorded, in step
        order (both workloads verify exactly what they speculated from)."""
        return st.queries

    def check_and_commit(self, srv, st, gt_ids, gt_scores) -> Tuple[int, object]:
        """Apply the workload's cache-update rule for the slot's verified
        rows and locate the first mis-speculated step. Returns
        ``(m, correction)``: ``m == len(st.specs)`` means the whole stride
        verified (correction is None); otherwise ``correction`` is the
        payload ``apply_correction``/``correction_stride`` need to replay
        step ``m`` correctly after the rollback restore."""
        raise NotImplementedError

    def seed_from_merged(self, srv, st, ids_row, scores_row) -> None:
        """Admission-time cache warm from one merged-call row (Algorithm 1
        line 4 / the continuous ride-along pre-seed)."""
        raise NotImplementedError

    def apply_correction(self, srv, slot: int, st, correction) -> None:
        """Per-slot fixup right after the rollback restore (before the
        batched correction stride)."""

    def correction_stride(self, srv, slots: Sequence[int], states,
                          corrections: Dict[int, object]) -> None:
        """ONE batched engine call correcting every rolled-back slot."""
        raise NotImplementedError


class IterativeRaLMWorkload(Workload):
    """The paper's Algorithm 1, byte-identical to the pre-workload fleet."""

    name = "ralm"
    equivalence = "byte"

    def verify_k(self, rcfg: RaLMConfig) -> int:
        return max(rcfg.prefetch_top_k, 1)

    def speculate_step(self, srv, doers, states):
        """Per-slot snapshot + cache-speculated doc swap, then ONE batched
        generation stride. A spec_id of -1 (cold cache) keeps the slot's
        previous doc; verification will correct — same as the single path."""
        eng, rcfg = srv.engine, srv.rcfg
        t_sub = time.perf_counter()
        steps = {}
        for b in doers:
            snap = eng.snapshot(b)
            q = srv._query_tokens(eng.tokens[b])
            ids, _ = states[b].cache.retrieve(q, 1)
            did = int(ids[0])
            if did >= 0:
                eng.set_doc(b, srv._doc(did))
            steps[b] = (snap, q, did, None)
        eng.gen(doers, [min(rcfg.generation_stride,
                            srv._slot_budget(b, states[b]))
                        for b in doers])
        return steps, time.perf_counter() - t_sub

    def check_and_commit(self, srv, st, gt_ids, gt_scores):
        k = self.verify_k(srv.rcfg)
        for row in gt_ids:
            srv._cache_insert(st.cache, row[:k])
        m = first_mismatch(st.specs, gt_ids)
        corr = int(gt_ids[m][0]) if m < len(st.specs) else None
        return m, corr

    def seed_from_merged(self, srv, st, ids_row, scores_row):
        srv._cache_insert(st.cache, ids_row)

    def apply_correction(self, srv, slot, st, correction):
        srv.engine.set_doc(slot, srv._doc(correction))

    def correction_stride(self, srv, slots, states, corrections):
        srv.engine.gen(slots, [min(srv.rcfg.generation_stride,
                                   srv._slot_budget(b, states[b]))
                               for b in slots])


class KNNLMWorkload(Workload):
    """KNN-LM through the fleet (paper §5.3): per-token retrieval,
    spatial-locality cache updates, token-match verification."""

    name = "knnlm"
    equivalence = "token-match"

    def validate(self, srv) -> None:
        if srv.sparse:
            raise ValueError(
                "KNN-LM serving needs a dense datastore retriever "
                "(ExactDenseRetriever/IVFRetriever over build_knn_datastore); "
                "got a sparse BM25 retriever")
        if getattr(srv.retriever.kb, "values", None) is None:
            raise ValueError(
                "KNN-LM serving needs a value-carrying datastore "
                "(DenseKB from build_knn_datastore); got a KB without "
                "per-entry values")

    def verify_k(self, rcfg: RaLMConfig) -> int:
        return max(rcfg.knn_k, 1)

    def speculate_step(self, srv, doers, states):
        """One TOKEN per sub-step and per slot: retrieve ``knn_k`` neighbours
        from the slot's speculation cache, interpolate their value
        distribution with the current LM logits, advance the batched engine
        ONE lockstep step with the chosen tokens. The logits are recorded as
        the step's aux — verification recomputes the token from them plus the
        KB's ground-truth neighbours, so a carried (overlapped) step stays
        verifiable a round later. Cold-cache slots interpolate against an
        empty neighbour mass (pure LM argmax scaled by 1-λ … which argmax
        ignores), exactly like the single-request KNNLMSpec."""
        eng, rcfg = srv.engine, srv.rcfg
        kb = srv.retriever.kb
        t_sub = time.perf_counter()
        steps, toks = {}, []
        for b in doers:
            snap = eng.snapshot(b)
            q = srv._query_tokens(eng.tokens[b])
            ids, sc = states[b].cache.retrieve(q, rcfg.knn_k)
            vals = np.where(ids >= 0, kb.values[np.maximum(ids, 0)], -1)
            logits = eng.peek_logits(b)
            with trace.span("knn.interpolate", role="speculate"):
                tok = knn_interpolate(logits, vals, sc, rcfg.knn_lambda)
            steps[b] = (snap, q, int(tok), logits)
            toks.append(int(tok))
        eng.advance(doers, toks)
        return steps, time.perf_counter() - t_sub

    def check_and_commit(self, srv, st, gt_ids, gt_scores):
        """Token-match verification (paper §5.3): step i is correct iff the
        token decoded from (recorded LM logits, KB ground-truth neighbours)
        equals the speculated token. By induction over matching prefixes the
        recorded logits equal what the sequential baseline saw, so the
        recomputed token IS the baseline's token — which is why the whole
        fleet stream token-matches KNNLMSeq. The cache-update rule is the
        spatial next-n insert for EVERY verified row (hit or miss)."""
        rcfg, kb = srv.rcfg, srv.retriever.kb
        n = len(st.specs)
        m, corr = n, None
        for i in range(n):
            with trace.span("knn.interpolate", role="verify"):
                gt_tok = knn_interpolate(st.aux[i], kb.values[gt_ids[i]],
                                         gt_scores[i], rcfg.knn_lambda)
            if gt_tok != int(st.specs[i]):
                m, corr = i, int(gt_tok)
                break
        for i in range(n):
            spatial_insert(kb, st.cache, gt_ids[i], rcfg.knn_prefetch_next_n)
        return m, corr

    def seed_from_merged(self, srv, st, ids_row, scores_row):
        spatial_insert(srv.retriever.kb, st.cache, ids_row,
                       srv.rcfg.knn_prefetch_next_n)

    def correction_stride(self, srv, slots, states, corrections):
        """ONE batched advance replaying each rolled-back slot's ground-truth
        token (the single-request path's ``eng.advance(gt_correct)``)."""
        srv.engine.advance(slots, [corrections[b] for b in slots])


def default_workload(rcfg: RaLMConfig) -> Workload:
    """The workload a server runs when not given one explicitly, keyed on
    ``rcfg.knnlm`` as in the reference."""
    return KNNLMWorkload() if rcfg.knnlm else IterativeRaLMWorkload()
