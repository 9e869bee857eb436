"""Workload interface: the Algorithm-1 specifics of a fleet speculation round
(the port's ``repro.serving.workload``).

``FleetServer._run_round`` is a workload-GENERIC two-stage pipeline — lockstep
speculation sub-steps, ONE merged verification KB call (dedup'd, shared-cache
published, fault-guarded, optionally overlapped on the async worker), then a
per-slot split with rollback/carry — but WHAT a speculation sub-step does,
what the merged rows mean, and what "the speculation was right" means are
workload properties. This module is that seam. The port carries the paper's
iterative RaLM (:class:`IterativeRaLMWorkload`, byte-parity equivalence);
KNN-LM serving is a later slice (ROADMAP.md).
"""
from __future__ import annotations

import time
from typing import Dict, Sequence, Tuple

from repro_torch.configs.base import RaLMConfig
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


def default_workload(rcfg: RaLMConfig) -> Workload:
    """The workload a server runs when not given one explicitly, keyed on
    ``rcfg.knnlm`` as in the reference."""
    if rcfg.knnlm:
        raise NotImplementedError(
            "KNN-LM serving (KNNLMWorkload) comes with the KNN-LM slice; the "
            "port serves the iterative RaLM workload")
    return IterativeRaLMWorkload()
