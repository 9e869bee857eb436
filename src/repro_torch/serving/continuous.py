"""ContinuousFleetServer: continuous batching for RaLMSpec fleet serving (the
port's ``repro.serving.continuous``).

FleetServer serves fixed groups of N requests in lockstep, so once fast
requests finish, their slots idle until the whole group drains. Continuous
batching removes that waste: the server owns a request queue and a pool of
engine slots, admits waiting requests into slots the moment they free up
mid-flight (per-slot prefill into the live batch, via
BatchedServeEngine.admit), and retires finished slots immediately. The round
loop is FleetServer._run_round over whatever slot set is live *this* round,
so every live slot's verification queries still merge into ONE batched KB
call per round no matter how the slot population churns — and that merged
call executes on whichever retrieval backend the retriever was built with
(numpy or the CUDA kernels).

Timeline: the server advances a MODELED clock (the paper's §A.1
batched-retrieval latency shape for KB calls + measured wall time for the
batched LM work, same convention as FleetServer.analytic_time). Request
arrivals are points on that clock — Poisson or trace-driven, see
``repro_torch.launch.serve --arrival-rate / --arrival-trace`` — and admission
happens when ``arrival <= clock`` and a slot is free, so queueing delay is
part of each request's reported latency. Wall-clock totals are reported
alongside.

Output preservation holds under churn: each request's tokens equal
single-request RaLMSeq's (KNNLMSeq's for KNN-LM) regardless of when it was
admitted, which slot it landed in, or what rollbacks its slot neighbors took.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from repro_torch.core.ralmspec import ServeResult
from repro_torch.serving.fleet import FleetServer


@dataclass
class Request:
    """One queued serving request on the modeled timeline."""

    rid: int
    prompt: Sequence[int]
    arrival: float = 0.0               # modeled arrival time (seconds)
    max_new: Optional[int] = None      # per-request budget; None -> rcfg's


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in 0..100) — the one definition shared by
    ContinuousResult and the scheduler benchmarks, so p50/p99 comparisons
    across schedulers can never diverge on rounding."""
    if not xs:
        return 0.0
    ys = sorted(xs)
    return ys[min(len(ys) - 1, max(0, round(q / 100.0 * (len(ys) - 1))))]


def as_requests(prompts: Sequence[Sequence[int]],
                arrivals: Optional[Sequence[float]] = None,
                max_new: Optional[Sequence[int]] = None) -> List[Request]:
    """Zip plain prompt lists into Request records (rid = position)."""
    return [Request(rid=i, prompt=p,
                    arrival=float(arrivals[i]) if arrivals is not None else 0.0,
                    max_new=max_new[i] if max_new is not None else None)
            for i, p in enumerate(prompts)]


@dataclass
class ContinuousResult:
    """Per-request ledgers (request order) plus the shared fleet timeline."""

    results: List[ServeResult] = field(default_factory=list)
    latencies: List[float] = field(default_factory=list)  # modeled finish-arrival
    wall_time: float = 0.0
    analytic_time: float = 0.0         # modeled makespan (clock at last retire)
    rounds: int = 0
    seed_calls: int = 0                # batched admission-seed KB calls
    kb_calls: int = 0
    kb_queries: int = 0
    max_live: int = 0                  # peak concurrently-live slots
    # in-round verification dedup ledger (same semantics as FleetResult)
    merged_rows: int = 0
    merged_rows_saved: int = 0
    # fault-tolerance ledger (same semantics as FleetResult), plus the
    # overload-shedding count: requests retired with status='shed' by the
    # bounded admission queue / queueing deadline before winning a slot
    kb_errors: int = 0
    kb_timeouts: int = 0
    kb_failures: int = 0
    seed_failures: int = 0
    degraded_rounds: int = 0
    worker_crashes: int = 0
    shed: int = 0

    @property
    def degraded_requests(self) -> int:
        return sum(1 for r in self.results if r.status == "degraded")

    @property
    def total_tokens(self) -> int:
        return sum(len(r.tokens) for r in self.results)

    def throughput(self, modeled: bool = True) -> float:
        """Aggregate tokens/s over the makespan (modeled timeline by default —
        the paper-hardware batched-retrieval shape; wall on this box)."""
        t = self.analytic_time if modeled else self.wall_time
        return self.total_tokens / max(t, 1e-9)

    def latency_percentile(self, q: float) -> float:
        """q-th percentile (0..100) of modeled per-request latency — queueing
        delay included, which is the point of measuring under an arrival rate."""
        return percentile(self.latencies, q)

    @property
    def p50(self) -> float:
        return self.latency_percentile(50)

    @property
    def p99(self) -> float:
        return self.latency_percentile(99)


class ContinuousFleetServer(FleetServer):
    """Queue + slot pool: admit mid-flight, retire on finish, one merged KB
    verification call per round over whichever slots are live.

    Admission seeding (Algorithm 1 line 4) rides along existing KB calls
    whenever it can: each round's merged verification call also carries seed
    queries for the arrived head of the queue (a queued request's seed query
    depends only on its prompt, so it can be computed before admission), and
    the pre-seeded ids are inserted into the request's fresh cache when it
    wins a slot — no separate KB call. A dedicated batched seed call (counted
    in ``ContinuousResult.seed_calls``) remains only for admission waves no
    verification call could have pre-seeded: the initial wave, waves after
    the pool drains idle, and requests that arrived after the last round's
    call was already issued.

    Async (pipelined) rounds compose with churn: the in-flight verification
    call lives entirely inside ``_run_round`` (submitted after stage-1
    speculation, joined before the per-slot split), so the slot population
    only ever mutates between rounds — ``_drain_inflight`` guards the
    admission and retirement paths against any future caller mutating slots
    while a call is still pending. Requests that arrive while the call is in
    flight ride it for pre-seeding (``_extra_verification_queries`` attaches
    their seed queries at submission time) and are admitted right after the
    join. A slot holding an unverified overlapped stride (a pending
    ``RequestState.carry``) cannot retire until the carry is verified —
    otherwise a final-stride mis-speculation would escape its correction."""

    def serve(self, requests: Sequence[Request]) -> ContinuousResult:
        eng, r, rcfg = self.engine, self.retriever, self.rcfg
        reqs = sorted(requests, key=lambda rq: (rq.arrival, rq.rid))
        queue = deque(reqs)
        eng.stats.reset()
        for b in range(eng.n_slots):        # a fresh serve() owns every slot
            if eng.active[b]:
                eng.retire(b)
        r0t = r.stats.time
        r0c, r0q = r.stats.calls, r.stats.queries
        m0, ms0 = self.merged_rows, self.merged_rows_saved
        r0e, r0o, r0f = r.stats.errors, r.stats.timeouts, r.stats.failed_calls
        sf0 = self.seed_failures
        out = ContinuousResult()
        states = {}                         # slot -> RequestState (live only)
        done = {}                           # rid  -> RequestState (retired)
        self._queue = queue
        self._preseed = {}                  # rid -> prefetched (ids, scores) rows
        self._extra_rids = []
        self._clock = clock = 0.0
        t0 = time.perf_counter()

        while queue or states:
            if not states and queue:        # pool drained: jump to next arrival
                clock = max(clock, queue[0].arrival)

            # ---- load shedding: graceful degradation under overload --------
            self._shed_overloaded(queue, done, out, clock, t0)

            # ---- admit: arrived requests into free slots, mid-flight -------
            # the slot population must never mutate under an in-flight
            # verification call (its query offsets index the pre-admission
            # participant list) — join it first; a no-op in the current
            # design, where _run_round drains its own call before returning
            self._drain_inflight()
            unseeded = []
            free = eng.free_slots()
            while queue and free and queue[0].arrival <= clock:
                rq = queue.popleft()
                b = free.pop(0)
                st = self._new_request_state(rid=rq.rid, max_new=rq.max_new)
                st.arrival, st.admitted = rq.arrival, clock
                st.res.admitted_ns = time.time_ns()
                eng.admit(b, list(rq.prompt)[-rcfg.max_prompt_len:])
                states[b] = st
                if rq.rid in self._preseed:  # seeded by an earlier round's call
                    self.workload.seed_from_merged(self, st,
                                                   *self._preseed.pop(rq.rid))
                    st.res.kb_calls += 1
                    st.res.kb_queries += 1
                else:
                    unseeded.append((b, st))
            if unseeded:
                # Algorithm 1 line 4, batched across the admission wave: ONE
                # KB call seeds every newly admitted un-preseeded slot's cache
                clock += self._seed_slots(unseeded)
                out.seed_calls += 1
            out.max_live = max(out.max_live, len(states))

            # ---- one speculation round over the currently live slot set ----
            # slots with a pending carry hold an UNVERIFIED overlapped stride:
            # they stay live past budget/EOS until it is verified (same rule
            # as FleetServer.serve and the single-request loop)
            live = [b for b in sorted(states)
                    if not self._slot_done(b, states[b]) or states[b].carry]
            if live:
                self._clock = clock
                a, _ = self._run_round(live, states, out)
                clock += a

            # ---- retire finished slots (frees them for the next admit) -----
            self._drain_inflight()
            for b in sorted(states):
                st = states[b]
                if self._slot_done(b, st) and not st.carry:
                    st.finished = clock
                    st.res.tokens = list(eng.generated(b))
                    st.res.analytic_time = clock - st.arrival
                    st.res.wall_time = time.perf_counter() - t0
                    self._finish(b, st)
                    done[st.rid] = st
                    eng.retire(b)
                    del states[b]

        out.wall_time = time.perf_counter() - t0
        out.analytic_time = clock
        out.kb_calls = r.stats.calls - r0c
        out.kb_queries = r.stats.queries - r0q
        out.merged_rows = self.merged_rows - m0
        out.merged_rows_saved = self.merged_rows_saved - ms0
        out.kb_errors = r.stats.errors - r0e
        out.kb_timeouts = r.stats.timeouts - r0o
        out.kb_failures = r.stats.failed_calls - r0f
        out.seed_failures = self.seed_failures - sf0
        # report in request order; gen/retrieval time are fleet-shared (the
        # batched engine pays them once), same convention as FleetServer.
        # Shed requests keep their result row (status='shed', no tokens) but
        # stay OUT of the latency distribution — p50/p99 describe service the
        # fleet actually delivered, shedding is its own counter.
        for rq in sorted(reqs, key=lambda x: x.rid):
            st = done[rq.rid]
            st.res.gen_time = eng.stats.gen_time
            st.res.retrieval_time = r.stats.time - r0t
            out.results.append(st.res)
            if st.res.status != "shed":
                out.latencies.append(st.finished - st.arrival)
        return out

    def _shed_overloaded(self, queue, done, out, clock: float,
                         t0: float) -> None:
        """Bounded admission + deadline-driven load shedding: retire waiting requests the fleet cannot serve in time with a ``shed``
        status instead of queueing unboundedly. ``rcfg.queue_deadline_s``
        sheds any ARRIVED request whose queueing delay already exceeds the
        deadline; ``rcfg.max_queue_depth`` then bounds how many arrived
        requests may keep waiting — newest arrivals are turned away first,
        the bounded-queue admission policy. Requests not yet arrived on the
        modeled clock are never considered (they haven't been offered)."""
        rcfg = self.rcfg
        if not (rcfg.max_queue_depth or rcfg.queue_deadline_s):
            return
        arrived = [rq for rq in queue if rq.arrival <= clock]
        drop = [rq for rq in arrived
                if rcfg.queue_deadline_s
                and clock - rq.arrival > rcfg.queue_deadline_s]
        if rcfg.max_queue_depth:
            waiting = [rq for rq in arrived if rq not in drop]
            # the head of the line is about to be admitted into free slots —
            # the depth bound applies to requests that actually keep waiting
            waiting = waiting[len(self.engine.free_slots()):]
            drop += waiting[rcfg.max_queue_depth:]
        for rq in drop:
            queue.remove(rq)
            st = self._new_request_state(rid=rq.rid, max_new=rq.max_new)
            st.arrival, st.finished = rq.arrival, clock
            st.res.status = "shed"
            st.res.analytic_time = clock - rq.arrival
            st.res.wall_time = time.perf_counter() - t0
            done[rq.rid] = st
            out.shed += 1

    # ---- seed-query ride-along (see class docstring) ------------------------
    def _extra_verification_queries(self, spec_elapsed: float):
        # the verification call is issued spec_elapsed past the round-start
        # clock, so requests that arrived during the speculation phase ride it
        issue_time = self._clock + spec_elapsed
        qs, self._extra_rids = [], []
        for rq in self._queue:
            if len(qs) >= self.engine.n_slots:
                break
            if rq.arrival <= issue_time and rq.rid not in self._preseed:
                qs.append(self._query_tokens(
                    list(rq.prompt)[-self.rcfg.max_prompt_len:]))
                self._extra_rids.append(rq.rid)
        return qs

    def _absorb_extra_verification(self, ids_rows, sc_rows) -> None:
        for rid, row, srow in zip(self._extra_rids, ids_rows, sc_rows):
            self._preseed[rid] = (row, srow)
        self._extra_rids = []
