"""FleetServer: RaLMSpec speculation rounds for N concurrent requests with
cross-request batched verification.

The paper batches one request's speculative queries into a single KB call
(§A.1: batched retrieval is near-constant-cost for EDR/SR). The fleet extends
that lever across requests: each round, every live slot runs its speculation
stride (lockstep batched decode via BatchedServeEngine), then ALL slots'
verification queries merge into ONE batched KB call. Per-request verification
cost becomes model_latency(sum of strides) / N — the §A.1 shape rewards this
directly, which is what bench_fleet.py measures.

The merged call is backend-agnostic: it goes through ``retriever.retrieve``,
which delegates execution to the retrieval-backend layer
(`repro_torch.retrieval.backends`) — in the reference, with
``--retriever-backend sharded`` (not ported yet), the one merged verification
call per round executes as ONE collective program over the KB shards, sync
or async/pipelined alike; here ``backend.calls == rounds + 1`` holds for the
CUDA kernel backend (tests/test_torch_serve.py).

Output preservation holds per slot: each slot owns a full Algorithm-1
:class:`~repro_torch.core.ralmspec.RequestState` (cache, OS^3, ledger), verification
compares against the same KB ground truth, and rollback restores only that
slot's row of the batched state. Fleet-served outputs are byte-identical to
per-request RaLMSeq outputs (tests/test_output_preservation.py).

A speculation round (``_run_round``) is defined over the *currently live* slot
set, not a fixed batch width: FleetServer.serve feeds it a fixed request group
until every member finishes, while :class:`ContinuousFleetServer`
(the reference's serving.continuous, not ported yet) feeds it whatever slots hold admitted requests this
instant — admitting queued requests into freed slots between rounds and
retiring finished ones, so slots never idle while work is waiting. Per-request
token budgets (``RequestState.max_new``) are honored per slot, which is what
lets heterogeneous-length requests share a fleet without the short ones
padding out to the longest.

Async (pipelined) fleet rounds — the fleet form of the paper's +A (§4,
Fig. 3): with ``async_rounds`` on, ``_run_round`` becomes a two-stage
pipeline. Stage one runs the round's lockstep speculation and SUBMITS the
merged verification KB call to a worker thread (the in-flight-verification
handle); while that call is in flight, the fleet immediately begins round
t+1's lockstep speculation stride from the caches (the *overlap* stride).
When the call completes, the per-slot split runs as usual — and any
mismatched slot has its overlapped speculation invalidated (the restore to
its round-t snapshot rewinds the overlapped steps too; a correction stride
follows), while fully-verified slots keep their overlapped work as a
multi-step carry (``RequestState.carry``) that pre-fills their next round.
Outputs stay byte-identical per slot (tests/test_async_fleet.py): overlapped
speculation is exactly as revocable as in-round speculation.

The overlap is adaptive, gated on the estimated verification latency vs a
speculation sub-step (``rcfg.async_gate_ratio``, same rule as the
single-request path): +A hurts cheap retrievers (ADR, paper Table 4), so
when b_est is small the round degrades gracefully to the synchronous shape.
On the analytic timeline an overlapped round pays the paper's ideal
``a_stage1 + max(a_overlap, b)`` instead of ``a_stage1 + a_overlap' + b`` —
carried steps are never re-charged. Per-slot OS^3 instances switch to the
async objective and observe the amortized ``b / n_participants``.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from repro_torch.configs.base import RaLMConfig
from repro_torch.core.cache import SharedRetrievalCache
from repro_torch.core.ralmspec import (RequestState, ServeResult, _ServerBase,
                                 dedup_queries)
from repro_torch.retrieval.faults import RetrievalFailed
from repro_torch.serving.workload import Workload, default_workload


@dataclass
class FleetResult:
    """Per-request ledgers plus the fleet-shared timeline."""

    results: List[ServeResult]
    wall_time: float = 0.0
    analytic_time: float = 0.0
    rounds: int = 0
    kb_calls: int = 0
    kb_queries: int = 0
    # in-round verification dedup ledger: rows actually sent to the KB across
    # all merged calls vs rows the byte-identical-query collapse saved
    merged_rows: int = 0
    merged_rows_saved: int = 0
    # fault-tolerance ledger (tests/test_faults.py). Attempt counters are
    # fleet-shared like kb_calls: KB-call attempts that raised and were
    # retried (kb_errors), attempts that overran the per-call deadline
    # (kb_timeouts), and calls that exhausted the whole retry budget
    # (kb_failures). degraded_rounds counts rounds that fell back to
    # speculation-only after such a failure; worker_crashes counts async
    # verification calls that raised on the worker and were re-run
    # synchronously; seed_failures counts failed admission-seed calls (those
    # only cost a cold speculation cache — never correctness).
    kb_errors: int = 0
    kb_timeouts: int = 0
    kb_failures: int = 0
    seed_failures: int = 0
    degraded_rounds: int = 0
    worker_crashes: int = 0
    # measured wall-clock overlap ledger (monotonic clock, this box — NOT the
    # modeled timeline): total wall seconds spent inside merged verification
    # KB calls (verify_wall_s — accumulated in sync AND async rounds), wall
    # seconds of the overlapped speculation strides the main thread ran while
    # a call was in flight (overlap_wall_s), and the intersection of the two
    # span sets (measured_overlap_s) — the seconds during which the worker's
    # BLAS/device scan and the LM stride were DEMONSTRABLY concurrent. Only
    # async rounds with the gate open contribute to the latter two; sync
    # fleets leave them at exactly 0. measured_overlap_s <=
    # min(verify_wall_s, overlap_wall_s) by construction.
    verify_wall_s: float = 0.0
    overlap_wall_s: float = 0.0
    measured_overlap_s: float = 0.0

    @property
    def degraded_requests(self) -> int:
        """Requests whose outputs are exempt from byte-parity because a
        verification call failed for good while they were live."""
        return sum(1 for r in self.results if r.status == "degraded")

    @property
    def total_tokens(self) -> int:
        return sum(len(r.tokens) for r in self.results)

    def throughput(self, modeled: bool = True) -> float:
        """Aggregate tokens/s across the fleet (modeled timeline by default —
        the paper-hardware batched-retrieval shape; wall on this 1-core box)."""
        t = self.analytic_time if modeled else self.wall_time
        return self.total_tokens / max(t, 1e-9)

    @property
    def latency(self) -> float:
        """Per-request latency: lockstep rounds finish together, so every
        request observes the shared fleet timeline."""
        return self.analytic_time


class FleetServer(_ServerBase):
    """Drives N RequestStates in lockstep over a BatchedServeEngine.

    ``async_rounds`` pipelines the rounds (see module docstring): None (the
    default) follows ``rcfg.async_verification`` — the fleet now honors the
    paper's +A configuration — while True/False force it regardless of the
    variant string. The synchronous path is byte-for-byte the previous
    behavior.

    ``workload`` selects the Algorithm-1 specifics the round loop runs
    (:mod:`repro_torch.serving.workload`): None picks by ``rcfg.knnlm`` —
    :class:`~repro_torch.serving.workload.IterativeRaLMWorkload` (byte-parity) or
    the reference's ``KNNLMWorkload`` (token-match, not ported yet). Everything
    workload-shared — merged KB call, dedup ledger, shared cache tier, fault
    shell, async overlap — lives here."""

    def __init__(self, engine, retriever, rcfg: RaLMConfig,
                 encoder=None, chunk_len: int = 64,
                 async_rounds: Optional[bool] = None,
                 shared_cache: Optional[SharedRetrievalCache] = None,
                 workload: Optional[Workload] = None):
        super().__init__(engine, retriever, rcfg, encoder, chunk_len,
                         shared_cache=shared_cache)
        self.workload = workload if workload is not None else default_workload(rcfg)
        self.workload.validate(self)
        self.async_rounds = (rcfg.async_verification if async_rounds is None
                             else async_rounds)
        self._pool = (ThreadPoolExecutor(max_workers=1)
                      if self.async_rounds else None)
        self._os3_async = self.async_rounds     # fleet OS^3 objective (A.2)
        self._inflight = None                   # in-flight verification handle
        # monotonic dedup ledger; serve() diffs it into the result object
        self.merged_rows = 0
        self.merged_rows_saved = 0
        # monotonic count of failed admission-seed calls (same diff pattern)
        self.seed_failures = 0
        # measured wall-clock overlap ledger (same diff pattern; see
        # FleetResult). time.monotonic spans: the worker records its KB-call
        # span in _verify_span, the round loop intersects it with the
        # overlapped stride's span. Both numpy BLAS and XLA release the GIL,
        # so the spans genuinely interleave even on one core — a positive
        # intersection is measured (not modeled) concurrency.
        self.verify_wall = 0.0
        self.overlap_wall = 0.0
        self.overlap_measured = 0.0
        self._verify_span = None

    # ---- per-slot predicates (fleet versions of _ServerBase._done/_budget) ---------
    # The inherited single-request forms read engine.finished/.generated, which on
    # a BatchedServeEngine are methods, not properties — fail loudly rather than
    # silently treating bound methods as truthy.
    def _done(self):
        raise NotImplementedError("FleetServer is per-slot: use _slot_done(b)")

    def _budget(self):
        raise NotImplementedError("FleetServer is per-slot: use _slot_budget(b)")

    def _slot_done(self, b: int, st: RequestState) -> bool:
        return (self.engine.finished(b)
                or len(self.engine.generated(b)) >= st.budget_limit(self.rcfg))

    def _slot_budget(self, b: int, st: RequestState) -> int:
        return st.budget_limit(self.rcfg) - len(self.engine.generated(b))

    def _extra_verification_queries(self, spec_elapsed: float) -> List:
        """Ride-along queries appended to the round's merged verification KB
        call. The fixed fleet has none; ContinuousFleetServer uses this to
        pre-seed queued requests' caches without a separate KB call.
        ``spec_elapsed`` is the round's speculation time so far — the call is
        issued that far past the round-start clock, so requests that arrived
        mid-round are eligible to ride it."""
        return []

    def _absorb_extra_verification(self, ids_rows, sc_rows) -> None:
        pass

    def _drain_inflight(self) -> None:
        """Join any in-flight verification call. ``_run_round`` always joins
        (and handles the failure of) its own call before returning, so
        between rounds this is a no-op — but slot-population mutations
        (admit/retire) go through it anyway so the invariant survives future
        reshaping of the pipeline. A leftover handle only exists on
        exceptional paths, so a raise from it is swallowed here: the drain's
        job is to make the join happen, and re-raising would poison
        ``close()`` with a failure the round loop already recovered from."""
        if self._inflight is not None:
            fut, self._inflight = self._inflight, None
            try:
                fut.result()
            except Exception:
                pass

    def close(self) -> None:
        """Release the verification worker thread. Long-lived processes that
        build servers per request group should call this (or use the server
        as a context manager) — the pool otherwise lives until process
        exit."""
        try:
            self._drain_inflight()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _dedup(self, queries):
        """Collapse byte-identical queries before a merged KB call (gated on
        ``rcfg.dedup_verification``). -> (unique_queries, inverse-or-None);
        scatter rows back with ``rows[inverse]``. Ledger counts live here so
        both the fixed and continuous serve loops can diff them."""
        if not self.rcfg.dedup_verification:
            self.merged_rows += len(queries)
            return list(queries), None
        uniq, inv = dedup_queries(queries)
        self.merged_rows += len(uniq)
        self.merged_rows_saved += len(queries) - len(uniq)
        return uniq, inv

    def _verify_merged(self, queries, k: int):
        """The round's merged verification KB call + shared-tier publish,
        behind the fault-tolerance shell (deadline + backoff retry — raises
        RetrievalFailed when the budget runs out; the round loop degrades).
        With async rounds this body runs on the worker thread — the publish
        is what lets slot t+1's overlapped speculation hit results verified
        for slot t, and it is safe because the shared tier locks. The
        monotonic span of the call is recorded either way (the round loop
        intersects it with the overlapped stride to measure real
        concurrency); reading it from the main thread is safe only after the
        future resolves."""
        t0 = time.monotonic()
        try:
            ids, scores = self._retrieve_guarded(queries, k)
            self._shared_put(queries, ids, scores)
        finally:
            t1 = time.monotonic()
            self._verify_span = (t0, t1)
            self.verify_wall += t1 - t0
        return ids, scores

    def _seed_slots(self, pairs) -> float:
        """Algorithm 1 line 4, cross-request batched: ONE KB call seeds every
        given (slot, state) pair's cache — deduplicated, so N identical
        prompts cost one KB row. Returns the modeled latency of the call
        (what the batched retrieval would cost on paper hardware).

        A seed call that fails after retries is absorbed, not raised: seeding
        only warms speculation (a cold cache speculates -1 and verification
        corrects), so the slots start cold and stay output-identical — the
        cheapest degradation in the stack (``seed_failures`` on the result)."""
        if not pairs:
            return 0.0
        q0 = [self._query_tokens(self.engine.tokens[b]) for b, _ in pairs]
        uniq, inv = self._dedup(q0)
        try:
            ids_u, sc_u = self._verify_merged(uniq,
                                              self.workload.verify_k(self.rcfg))
        except RetrievalFailed:
            self.seed_failures += 1
            return (self.retriever.stats.model_latency(len(uniq))
                    + self._take_ft_overhead())
        ids0 = ids_u if inv is None else ids_u[inv]
        sc0 = sc_u if inv is None else sc_u[inv]
        for (b, st), row, srow in zip(pairs, ids0, sc0):
            self.workload.seed_from_merged(self, st, row, srow)
            # per-slot ledger: batched KB calls the slot PARTICIPATED in (so a
            # slot's kb_calls is comparable to single-request RaLMSpec's
            # 1 initial + 1 per round); FleetResult.kb_calls counts the actual
            # shared calls, so the per-slot sum exceeds it by design.
            st.res.kb_calls += 1
            st.res.kb_queries += 1
        return (self.retriever.stats.model_latency(len(uniq))
                + self._take_ft_overhead())

    def _lockstep_substep(self, doers: Sequence[int], states) -> tuple:
        """One batched speculation sub-step over ``doers`` — dispatched to the
        workload (iterative RaLM: doc swap + ONE batched generation stride;
        KNN-LM: cache-neighbour interpolation + ONE batched single-token
        advance). Returns ``({slot: (snap, query, spec, aux)},
        wall_seconds)``."""
        return self.workload.speculate_step(self, doers, states)

    def _overlap_speculate(self, slots: Sequence[int], states,
                           strides: Dict[int, int], a_est: float,
                           b_est: float, fut=None) -> tuple:
        """Round t+1's lockstep speculation, run while round t's merged
        verification call is in flight. Steps are recorded per slot as
        TENTATIVE carry steps (never into the round scratch): a slot that
        round t rolls back discards them wholesale.

        Two bounds compose. The MODELED window: sub-steps run only while the
        next one is expected to still fit under ``b_est`` — those steps are
        FREE on the analytic timeline (the round pays ``max(a_overlap, b)``),
        so an overlapped round costs no more than a synchronous one up to
        a_est/b_est estimation error, even when every slot's overlap is later
        invalidated; inside it a slot speculates at most its next stride (the
        carry that pre-fills round t+1). The IN-FLIGHT extension: when the
        verification future is handed in and has NOT resolved yet, keep
        speculating past both the window and the per-slot stride cap, up to
        each slot's remaining token budget — the worker is still inside its
        KB scan / service wait (GIL released), so on the wall clock those
        deep steps are reclaimed idle time, and every one of them pre-fills a
        future stride, so surviving deep carries collapse whole rounds (and
        their merged KB calls). ``fut.done()`` is the (cheap) oracle: a call
        that returns quickly grants no extra depth, a slow one — big KB,
        remote/disk service latency — grants a lot. ``rcfg.async_min_overlap``
        forces that many sub-steps regardless of the window (tests use it to
        exercise the carry paths on stacks whose retrieval is too cheap to
        hide anything).

        Analytic accounting: overlapped sub-steps are charged at ``a_est``
        (the round's calibrated uncontended per-step cost), NOT at their
        measured wall — on this 1-core container the verification worker's
        BLAS scan contends with the overlapped LM work, roughly doubling its
        wall time, which the paper's parallel hardware would not see. This is
        the same strategy the paper itself uses for +A's analytic ideal under
        the GIL (§5.1); wall-clock totals report the contended truth, as
        everywhere. Returns
        ``({slot: [(snap, query, spec, a_est, aux), ...]}, modeled_seconds)``
        — 5-tuples matching ``RequestState.record_step``, so carried steps
        replay through ``begin_round`` with their workload aux intact (KNN-LM
        verifies a carried token from its recorded logits a round later)."""
        overlap: Dict[int, List[tuple]] = {b: [] for b in slots}
        n_sub = 0
        while True:
            in_flight = fut is not None and not fut.done()
            if (n_sub >= self.rcfg.async_min_overlap
                    and (n_sub + 1) * a_est > b_est
                    and not in_flight):
                break                       # window overrun and call resolved
            doers = [b for b in slots
                     if (len(overlap[b]) < strides[b] or in_flight)
                     and not self._slot_done(b, states[b])]
            if not doers:
                break
            steps, _ = self._lockstep_substep(doers, states)
            n_sub += 1
            for b in doers:
                snap, q, spec, aux = steps[b]
                overlap[b].append((snap, q, spec, a_est, aux))
        return {b: ov for b, ov in overlap.items() if ov}, n_sub * a_est

    def _run_round(self, live: Sequence[int], states, fleet) -> tuple:
        """One Algorithm-1 speculation round over the CURRENTLY live slot set.

        ``live`` is any subset of engine slots; ``states`` maps slot id ->
        RequestState (a list works for the fixed fleet, a dict for the
        continuous fleet). Two-stage pipeline:

          stage 1 — lockstep speculation sub-steps (carried overlap steps from
              the previous round pre-fill each slot's scratch), then the ONE
              merged verification KB call: submitted to the worker thread when
              async rounds are on and the adaptive gate passes, issued inline
              otherwise;
          stage 2 — while the call is in flight, the next round's lockstep
              overlap stride; then join, per-slot split, carry assignment /
              invalidation, and the batched correction stride for whichever
              slots mis-speculated.

        Returns ``(analytic_seconds, n_participants)``; ``fleet`` only needs a
        ``rounds`` counter (FleetResult or ContinuousResult).
        """
        eng, r, rcfg = self.engine, self.retriever, self.rcfg
        analytic = 0.0
        strides = {b: max(states[b].stride(rcfg), 1) for b in live}
        for b in live:
            states[b].begin_round()

        # ---- stage 1: lockstep speculation, one batched decode per sub-step -
        while True:
            doers = [b for b in live
                     if len(states[b].specs) < strides[b]
                     and not self._slot_done(b, states[b])]
            if not doers:
                break
            steps, a_sub = self._lockstep_substep(doers, states)
            # the sub-step runs batched: the fleet pays it once, every
            # participant's OS^3 sees it as its per-step a
            analytic += a_sub
            for b in doers:
                snap, q, spec, aux = steps[b]
                states[b].record_step(snap, q, spec, a_sub, aux)
                if states[b].os3:
                    states[b].os3.record_speculation(a_sub)

        participants = [b for b in live if states[b].specs]
        if not participants:
            return analytic, 0

        # ---- cross-request batched verification: ONE KB call per round ------
        # Ride-along queries (continuous batching pre-seeds queued requests'
        # caches this way) share the same call — batched retrieval is
        # near-constant-cost (§A.1), so they are almost free. With async
        # rounds they attach to the in-flight call at submission time.
        extra = self._extra_verification_queries(analytic)
        all_queries = [q for b in participants
                       for q in self.workload.build_verification_queries(states[b])]
        all_queries += list(extra)
        k = self.workload.verify_k(rcfg)
        # in-round dedup: one KB row per UNIQUE query in the merged call;
        # rows scatter back to slots below. The latency model sees the
        # deduplicated width — that's the saving.
        uniq, inv = self._dedup(all_queries)

        # adaptive overlap gate, the fleet form of the single path's rule:
        # only pipeline when the modeled verification latency is worth hiding
        # (ADR's cheap probes make the overlap pure downside, paper Table 4)
        overlap: Dict[int, List[tuple]] = {}
        overlap_a = 0.0
        gt_u = sc_u = None
        if self._pool is not None:
            a_all = [a for b in participants for a in states[b].a_times]
            a_est = sum(a_all) / max(len(a_all), 1)
            b_est = r.stats.model_latency(len(uniq))
            if b_est > rcfg.async_gate_ratio * a_est:
                # ---- stage 2: overlap the call with round t+1's stride ------
                self._verify_span = None
                self._inflight = self._pool.submit(
                    self._verify_merged, uniq, k)
                t_ov0 = time.monotonic()
                try:
                    overlap, overlap_a = self._overlap_speculate(
                        participants, states, strides, a_est, b_est,
                        fut=self._inflight)
                finally:
                    t_ov1 = time.monotonic()
                    # clear the handle BEFORE joining: if the worker call
                    # raised, a still-set handle would poison _drain_inflight
                    # and close() with the same re-raise
                    fut, self._inflight = self._inflight, None
                try:
                    gt_u, sc_u = fut.result()
                    # measured concurrency: the worker's KB-call span
                    # (written before the future resolved — the join is the
                    # happens-before edge) intersected with the overlapped
                    # stride's span, both on the monotonic clock
                    if self._verify_span is not None:
                        v0, v1 = self._verify_span
                        self.overlap_wall += t_ov1 - t_ov0
                        self.overlap_measured += max(
                            0.0, min(v1, t_ov1) - max(v0, t_ov0))
                except Exception:
                    # worker crash recovery: the in-flight verification died
                    # (RetrievalFailed after its retries, or anything else the
                    # worker hit). Discard the overlapped stride exactly as a
                    # rollback would — restoring each slot's first overlap
                    # snapshot rewinds the tentative steps — then fall back to
                    # a synchronous verification round below, which gets a
                    # fresh retry budget. The round, not the server, dies
                    # last: only a failed *synchronous* call degrades.
                    fleet.worker_crashes += 1
                    for b, steps in overlap.items():
                        eng.restore(b, steps[0][0])
                        states[b].res.carry_invalidations += 1
                    overlap, overlap_a = {}, 0.0
        if gt_u is None:                        # sync round / closed gate / fallback
            try:
                gt_u, sc_u = self._verify_merged(uniq, k)
            except RetrievalFailed:
                if not rcfg.degrade_on_failure:
                    raise
                # ---- graceful degradation: speculation-only round -----------
                # The KB is unreachable for good (this round): accept every
                # slot's speculated stride as served output — no rollback, no
                # cache update — and mark the requests degraded, which exempts
                # them from the byte-parity claim (shared-cache/speculation
                # quality only; the stream stays available instead of dying).
                # Ride-along seed queries are dropped (their requests take the
                # dedicated seed path later); OS^3 sees no verification.
                analytic += self._take_ft_overhead()
                fleet.rounds += 1
                fleet.degraded_rounds += 1
                self._absorb_extra_verification([], [])
                for b in participants:
                    st = states[b]
                    n = len(st.specs)
                    st.res.status = "degraded"
                    st.res.rounds += 1
                    st.res.spec_steps += n
                    st.res.strides.append(n)
                return analytic, len(participants)
        gt_all = gt_u if inv is None else gt_u[inv]
        sc_all = sc_u if inv is None else sc_u[inv]
        b_model = r.stats.model_latency(len(uniq))
        # analytic ideal (paper §4, fleet-wide): an overlapped round pays
        # max(a_overlap, b) for the in-flight window; a plain round pays b.
        # Failed attempts (retries/backoff, a crashed worker call) are charged
        # on top at their modeled cost via the guarded call's accumulator.
        analytic += max(overlap_a, b_model) if overlap_a else b_model
        analytic += self._take_ft_overhead()
        fleet.rounds += 1
        if extra:
            self._absorb_extra_verification(gt_all[-len(extra):],
                                            sc_all[-len(extra):])

        # ---- split per slot: cache update, mismatch, carry, bookkeeping -----
        rollbacks = []           # slots needing a correction stride
        corrections = {}         # slot -> workload correction payload
        off = 0
        for b in participants:
            st = states[b]
            n = len(st.specs)
            gt = gt_all[off:off + n]
            sc = sc_all[off:off + n]
            off += n
            m, corr = self.workload.check_and_commit(self, st, gt, sc)
            if st.os3:
                # amortized share: the batched call serves every participant
                st.os3.record_verification(b_model, n, m,
                                           n_participants=len(participants))
            st.res.rounds += 1
            st.res.spec_steps += n
            st.res.strides.append(n)
            st.res.kb_calls += 1
            st.res.kb_queries += n
            if m < n:
                st.res.mismatches += 1
                if overlap.pop(b, None):
                    # the overlapped stride speculated past a wrong step: the
                    # restore below rewinds it along with steps m..n-1
                    st.res.carry_invalidations += 1
                eng.restore(b, st.snaps[m])
                self.workload.apply_correction(self, b, st, corr)
                rollbacks.append(b)
                corrections[b] = corr
            elif b in overlap:
                st.carry = overlap.pop(b)
                st.res.carry_steps += len(st.carry)
                if st.os3:
                    for step in st.carry:
                        st.os3.record_speculation(step[3])

        # ---- corrections: ONE batched engine call for all rollbacks ---------
        if rollbacks:
            tc = time.perf_counter()
            self.workload.correction_stride(self, rollbacks, states, corrections)
            analytic += time.perf_counter() - tc
        return analytic, len(participants)

    def serve(self, prompts: Sequence[Sequence[int]],
              max_new: Optional[Sequence[int]] = None) -> FleetResult:
        """Serve a fixed request group to completion. ``max_new`` optionally
        gives per-request token budgets (default: rcfg.max_new_tokens for all —
        the continuous path is the one that exercises heterogeneity, but the
        fixed fleet honors budgets too so the two are benchmark-comparable)."""
        eng, rcfg = self.engine, self.rcfg
        r = self.retriever
        B = len(prompts)
        assert B <= eng.n_slots, f"{B} requests > {eng.n_slots} fleet slots"
        eng.stats.reset()
        r0t = r.stats.time
        r0c, r0q = r.stats.calls, r.stats.queries
        m0, ms0 = self.merged_rows, self.merged_rows_saved
        r0e, r0o, r0f = r.stats.errors, r.stats.timeouts, r.stats.failed_calls
        sf0 = self.seed_failures
        vw0, ow0, mo0 = self.verify_wall, self.overlap_wall, self.overlap_measured
        states = [self._new_request_state(
            rid=b, max_new=max_new[b] if max_new is not None else None)
            for b in range(B)]
        fleet = FleetResult(results=[st.res for st in states])
        t0 = time.perf_counter()

        for b, p in enumerate(prompts):
            eng.start(b, list(p)[-rcfg.max_prompt_len:])
        analytic = self._seed_slots([(b, states[b]) for b in range(B)])

        while True:
            # NB: a slot with a pending carry is holding an UNVERIFIED
            # overlapped stride — it must stay live past budget/EOS until the
            # carry is verified (and corrected if wrong), or output
            # preservation breaks on the final stride (same rule as the
            # single-request loop).
            live = [b for b in range(B)
                    if not self._slot_done(b, states[b]) or states[b].carry]
            if not live:
                break
            a, n_part = self._run_round(live, states, fleet)
            analytic += a
            if n_part == 0:
                break

        fleet.wall_time = time.perf_counter() - t0
        fleet.analytic_time = analytic
        fleet.kb_calls = r.stats.calls - r0c
        fleet.kb_queries = r.stats.queries - r0q
        fleet.merged_rows = self.merged_rows - m0
        fleet.merged_rows_saved = self.merged_rows_saved - ms0
        fleet.kb_errors = r.stats.errors - r0e
        fleet.kb_timeouts = r.stats.timeouts - r0o
        fleet.kb_failures = r.stats.failed_calls - r0f
        fleet.seed_failures = self.seed_failures - sf0
        fleet.verify_wall_s = self.verify_wall - vw0
        fleet.overlap_wall_s = self.overlap_wall - ow0
        fleet.measured_overlap_s = self.overlap_measured - mo0
        # per-slot time fields are the SHARED fleet timeline (lockstep rounds
        # finish together): don't sum them across slots — like kb_calls above,
        # summing overcounts by the concurrency factor. Aggregate via
        # FleetResult instead.
        for b, st in enumerate(states):
            st.res.tokens = list(eng.generated(b))
            st.res.wall_time = fleet.wall_time
            st.res.analytic_time = analytic
            st.res.gen_time = eng.stats.gen_time
            st.res.retrieval_time = r.stats.time - r0t
        return fleet
