"""RaLMSpec: speculative retrieval + batched verification for iterative RaLM serving
(paper Algorithm 1), plus the RaLMSeq baseline (Ram et al. 2023 style: retrieve every
k generated tokens, prepend-replace the latest chunk).

Output preservation: RaLMSpec.serve() produces *exactly* the token sequence of
RaLMSeq.serve() for the same request (greedy decoding + rank-preserving cache +
rollback-on-mismatch), and the multi-request fleet paths preserve it per slot:
repro_torch.serving.fleet.FleetServer at any fixed concurrency, and
repro_torch.serving.continuous.ContinuousFleetServer under continuous batching — no
matter when a request is admitted, which slot it lands in, or what rollbacks its
slot neighbors take. tests/test_system.py asserts the single-request claim;
tests/test_output_preservation.py the batched-engine and fixed-fleet claims;
tests/test_continuous.py the continuous-batching claim, each for every retriever
type. Together they guard the paper's central claim.

Per-request Algorithm-1 state (the speculation cache, the async carry, the OS^3
scheduler instance, and the latency ledger) lives in :class:`RequestState` so the
single-request server here and BOTH fleet servers drive the *same* state machine.
The carry is a per-request list of speculative steps taken while a verification
call was in flight: the single-request path carries at most one extra step
(paper Figure 3), while the async fleet path
(:class:`repro_torch.serving.fleet.FleetServer` with ``async_rounds``) overlaps the
merged verification call with the whole next lockstep stride and carries every
overlapped step of each fully-verified slot:

  * ``repro_torch.serving.fleet.FleetServer`` runs N of them in lockstep over a fixed
    request group,
  * ``repro_torch.serving.continuous.ContinuousFleetServer`` runs them over a slot
    pool with continuous batching — requests are admitted into slots the moment
    they free up mid-flight and retired as they finish, so ``RequestState`` also
    carries request identity (``rid``), a per-request token budget (``max_new``),
    and the modeled arrival/admission/finish clock.

Each round, every live slot's verification queries merge into one batched KB call
(cross-request batched verification; §A.1 shows batched retrieval is
near-constant-cost for EDR/SR, so the merged call amortizes).

Latency ledger: wall-clock segments are recorded per component (G = prefill+decode,
R = retrieval) exactly like the paper's Figure 4 decomposition. Async verification
additionally maintains the paper's *analytic* ideal-overlap timeline (their §5.1
simulated latency) next to the real threaded overlap.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import RaLMConfig
from repro_torch.core.cache import (DenseRetrievalCache, SharedCacheView,
                              SharedRetrievalCache, SparseRetrievalCache,
                              query_key)
from repro_torch.core.scheduler import OS3
from repro_torch.retrieval.encoder import ContextEncoder
from repro_torch.retrieval.faults import RetrievalFailed, RetrievalTimeout
from repro_torch.retrieval.retrievers import BM25Retriever


@dataclass
class ServeResult:
    tokens: List[int]
    wall_time: float
    analytic_time: float
    gen_time: float
    retrieval_time: float
    kb_calls: int
    kb_queries: int
    rounds: int = 0
    mismatches: int = 0
    spec_steps: int = 0
    strides: List[int] = field(default_factory=list)
    # async overlap accounting: speculative steps taken while a verification
    # call was in flight and kept (carry_steps) vs thrown away because the
    # round they overlapped mis-speculated (carry_invalidations)
    carry_steps: int = 0
    carry_invalidations: int = 0
    # fault-tolerance status: 'ok' | 'degraded' (a merged verification call
    # failed after retries while this request was live — some of its rounds
    # served speculation-only, so it is EXEMPT from the byte-parity claim,
    # mirroring the quantized backends' exact-bit pattern) | 'shed' (retired
    # by continuous-batching load shedding before serving a single token)
    status: str = "ok"
    # the fleet servers' wall clock on the tracer's (``time.time_ns``, Unix
    # ns): the request won its slot (before its first prefill), its first
    # token settled (the end of its first verified round), it finished (its
    # slot done with nothing left to verify); 0 where no fleet served it
    admitted_ns: int = 0
    first_token_ns: int = 0
    finished_ns: int = 0

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    @property
    def speedup_denominator(self) -> float:
        return self.wall_time


def _chunk(doc: Sequence[int], chunk_len: int) -> tuple:
    """Fixed-length doc chunk (paper: max retrieved chunk length, padded for jit
    shape reuse; pad token 1 is reserved)."""
    d = list(doc)[:chunk_len]
    return tuple(d + [1] * (chunk_len - len(d)))


def first_mismatch(specs: Sequence[int], gt_ids) -> int:
    """Index of the first speculated doc id that disagrees with the verified top-1
    (Algorithm 1 line 9); == len(specs) when the whole stride verified."""
    for i in range(len(specs)):
        if int(specs[i]) != int(gt_ids[i][0]):
            return i
    return len(specs)


def dedup_queries(queries):
    """Collapse duplicate queries ahead of a merged verification call.

    -> (unique_queries, inverse) with ``queries[i] == unique_queries[inverse[i]]``
    (byte-equality via :func:`query_key`). The KB retrieves one row per UNIQUE
    query and the caller scatters rows back to slots with ``rows[inverse]`` —
    output-invariant because retrieval is a pure function of the query, so
    identical queries get identical rows either way.
    """
    uniq, inverse, index = [], [], {}
    for q in queries:
        key = query_key(q)
        pos = index.get(key)
        if pos is None:
            pos = index[key] = len(uniq)
            uniq.append(q)
        inverse.append(pos)
    return uniq, np.asarray(inverse, np.int64)


@dataclass
class RequestState:
    """Per-request Algorithm-1 state, shared by the single-request server and the
    fleet path: the speculation cache, the OS^3 scheduler instance, the async
    carry, the analytic timeline, the result ledger, and the current round's
    scratch (snapshots / queries / speculated ids / per-step latencies)."""

    cache: object
    os3: Optional[OS3]
    res: ServeResult
    analytic: float = 0.0
    # multi-step async carry: [(snap, query, spec_id, a_latency[, aux]), ...]
    # of UNVERIFIED speculative steps taken while the previous round's
    # verification call was in flight. The single-request path carries at most
    # one step; the async fleet carries up to a whole overlapped stride. The
    # optional 5th element is the workload's per-step auxiliary record (the
    # iterative-RaLM workload has none; KNN-LM carries the LM logits its
    # token-match verification recomputes against).
    carry: List[tuple] = field(default_factory=list)
    snaps: List = field(default_factory=list)
    queries: List = field(default_factory=list)
    specs: List[int] = field(default_factory=list)
    a_times: List[float] = field(default_factory=list)
    aux: List = field(default_factory=list)
    # continuous-batching identity + timing (the reference's continuous server): which
    # request this state belongs to, its own token budget, and where it sits on
    # the modeled clock. The lockstep paths leave these at their defaults.
    rid: int = -1                      # request id (stable across slot reuse)
    max_new: Optional[int] = None      # per-request budget; None -> rcfg's
    arrival: float = 0.0               # modeled time the request arrived
    admitted: float = 0.0              # modeled time it won a slot
    finished: float = 0.0              # modeled time it was retired

    def stride(self, rcfg: RaLMConfig) -> int:
        return self.os3.stride if self.os3 else rcfg.speculation_stride

    def budget_limit(self, rcfg: RaLMConfig) -> int:
        """Token budget for THIS request (per-request under continuous batching)."""
        return self.max_new if self.max_new is not None else rcfg.max_new_tokens

    def begin_round(self) -> None:
        """Reset the round scratch, pre-loading any carried (already executed,
        not yet verified) overlap steps — their latencies ride along in
        ``a_times`` but are NOT re-charged to the analytic timeline (they were
        paid under the previous round's ``max(a_overlap, b)``)."""
        self.snaps, self.queries, self.specs = [], [], []
        self.a_times, self.aux = [], []
        for step in self.carry:
            self.record_step(*step)
        self.carry = []

    def record_step(self, snap, query, spec_id: int, a_latency: float,
                    aux=None) -> None:
        self.snaps.append(snap)
        self.queries.append(query)
        self.specs.append(spec_id)
        self.a_times.append(a_latency)
        self.aux.append(aux)


class _ServerBase:
    def __init__(self, engine, retriever, rcfg: RaLMConfig,
                 encoder: Optional[ContextEncoder] = None, chunk_len: int = 64,
                 shared_cache: Optional[SharedRetrievalCache] = None):
        self.engine = engine
        self.retriever = retriever
        self.rcfg = rcfg
        self.encoder = encoder
        self.chunk_len = chunk_len
        self.sparse = isinstance(retriever, BM25Retriever)
        # fleet-scale shared speculation tier (None = per-request caches only).
        # Strictly a speculation source: verification still confirms every doc.
        self.shared_cache = shared_cache
        # whether per-request OS^3 instances optimize the async objective;
        # FleetServer overrides this when pipelined (async) rounds are on
        self._os3_async = rcfg.async_verification
        # modeled cost of failed KB-call attempts (retries, backoff): the
        # guarded call accumulates it here — possibly from the verification
        # worker thread — and the round loop drains it into the analytic
        # timeline after the join
        self._ft_lock = threading.Lock()
        self._ft_overhead = 0.0

    def _query_tokens(self, toks):
        """Context-dependent query summarizing an explicit context (paper §1) —
        the fleet path passes per-slot token lists through here."""
        if self.sparse:
            return list(toks[-32:])
        return self.encoder.encode(toks)

    def _query(self):
        return self._query_tokens(self.engine.tokens)

    def _retrieve_batch(self, queries, k: int):
        if self.sparse:
            return self.retriever.retrieve(queries, k)
        return self.retriever.retrieve(np.stack(queries), k)

    def _retrieve_guarded(self, queries, k: int):
        """The fault-tolerance shell around a KB call: per-call deadline +
        exponential-backoff retry (``rcfg.retry_max`` / ``retry_backoff_s`` /
        ``retrieval_timeout_s``). KB search is a pure function of the query,
        so a retried call returns byte-identical rows and recovery from any
        transient fault schedule is output-preserving by construction
        (tests/test_faults.py). The deadline is enforced post hoc — a call
        that overruns it completes, but its rows are discarded and the call
        retried, which the same determinism makes safe.

        Raises :class:`~repro_torch.retrieval.faults.RetrievalFailed` once the
        budget is exhausted; the fleet round loop degrades gracefully.
        Failed attempts are charged to the analytic timeline at the modeled
        batched-call cost (plus any real backoff sleeps) via the
        ``_ft_overhead`` accumulator, and counted on ``RetrieverStats``."""
        rcfg, stats = self.rcfg, self.retriever.stats
        last = None
        for attempt in range(rcfg.retry_max + 1):
            final = attempt == rcfg.retry_max
            if attempt:
                backoff = rcfg.retry_backoff_s * (2 ** (attempt - 1))
                if backoff:
                    time.sleep(backoff)
                with self._ft_lock:
                    self._ft_overhead += backoff
            t0 = time.perf_counter()
            try:
                ids, scores = self._retrieve_batch(queries, k)
            except Exception as e:     # any backend fault is assumed transient
                last = e
                stats.record_failure("error", final=final)
                with self._ft_lock:
                    self._ft_overhead += stats.model_latency(len(queries))
                continue
            dt = time.perf_counter() - t0
            if rcfg.retrieval_timeout_s and dt > rcfg.retrieval_timeout_s:
                last = RetrievalTimeout(
                    f"KB call took {dt:.3f}s > "
                    f"{rcfg.retrieval_timeout_s:.3f}s deadline")
                stats.record_failure("timeout", final=final)
                with self._ft_lock:
                    self._ft_overhead += stats.model_latency(len(queries))
                continue
            return ids, scores
        raise RetrievalFailed(
            f"KB call failed after {rcfg.retry_max + 1} attempts") from last

    def _take_ft_overhead(self) -> float:
        """Drain the modeled cost of failed attempts accumulated since the
        last drain (thread-safe: the guarded call may run on the worker)."""
        with self._ft_lock:
            o, self._ft_overhead = self._ft_overhead, 0.0
            return o

    def _doc(self, doc_id: int) -> tuple:
        return _chunk(self.retriever.kb.docs[int(doc_id)], self.chunk_len)

    def _done(self) -> bool:
        return (self.engine.finished
                or len(self.engine.generated) >= self.rcfg.max_new_tokens)

    def _budget(self) -> int:
        return self.rcfg.max_new_tokens - len(self.engine.generated)

    # ---- per-request state (shared with the fleet path) ----------------------------
    def _new_cache(self):
        if self.sparse:
            local = SparseRetrievalCache(self.retriever.kb,
                                         self.rcfg.cache_capacity)
        else:
            local = DenseRetrievalCache(self.retriever.kb.embeddings.shape[1],
                                        self.rcfg.cache_capacity)
        if self.shared_cache is not None:
            return SharedCacheView(local, self.shared_cache)
        return local

    def _shared_put(self, queries, ids, scores) -> None:
        """Publish verified KB rows to the shared tier (no-op when disabled).
        Called from whichever thread ran the verification call — the tier is
        lock-guarded, so the async worker may publish while the main thread's
        overlapped speculation stride is reading."""
        if self.shared_cache is None:
            return
        for q, row_i, row_s in zip(queries, ids, scores):
            self.shared_cache.put(q, row_i, row_s)

    def _cache_insert(self, cache, ids_row):
        ids_row = [int(i) for i in ids_row if int(i) >= 0]
        if not ids_row:
            return
        if self.sparse:
            cache.insert(ids_row)
        else:
            cache.insert(ids_row, self.retriever.keys_of(ids_row))

    def _new_request_state(self, cache=None, rid: int = -1,
                           max_new: Optional[int] = None) -> RequestState:
        rcfg = self.rcfg
        os3 = OS3(window=rcfg.os3_window, gamma_max=rcfg.gamma_max,
                  max_stride=rcfg.max_stride,
                  async_mode=self._os3_async) if rcfg.use_os3 else None
        return RequestState(
            cache=cache if cache is not None else self._new_cache(), os3=os3,
            rid=rid, max_new=max_new,
            res=ServeResult(tokens=[], wall_time=0, analytic_time=0, gen_time=0,
                            retrieval_time=0, kb_calls=0, kb_queries=0))


class RaLMSeq(_ServerBase):
    """The paper's baseline: one KB retrieval every generation stride."""

    def serve(self, prompt: Sequence[int]) -> ServeResult:
        eng, r = self.engine, self.retriever
        eng.stats.reset()
        r0c, r0q, r0t = r.stats.calls, r.stats.queries, r.stats.time
        r0m = r.stats.modeled_time
        t0 = time.perf_counter()
        eng.start(list(prompt)[-self.rcfg.max_prompt_len:])
        while not self._done():
            q = self._query()
            ids, _ = self._retrieve_batch([q], 1)
            eng.set_doc(self._doc(ids[0, 0]))
            eng.gen(min(self.rcfg.generation_stride, self._budget()))
        wall = time.perf_counter() - t0
        measured_r = r.stats.time - r0t
        modeled_r = r.stats.modeled_time - r0m
        return ServeResult(
            tokens=list(eng.generated), wall_time=wall,
            analytic_time=wall - measured_r + modeled_r,
            gen_time=eng.stats.gen_time, retrieval_time=measured_r,
            kb_calls=r.stats.calls - r0c, kb_queries=r.stats.queries - r0q)


class RaLMSpec(_ServerBase):
    """Algorithm 1 with optional Prefetching (P), OS^3 (S), Async verification (A).

    ``persistent_cache=True`` (beyond-paper) keeps retrieval results across
    requests instead of the paper's per-request cache: topically-related requests
    warm each other's speculation. It is implemented as a private
    :class:`SharedRetrievalCache` (the same lock-guarded tier the fleet servers
    share), so it is safe even when the async verification worker publishes
    results while the main thread speculates. Output preservation is unaffected —
    cache contents only steer *speculation*; verification still compares against
    the KB.
    """

    def __init__(self, engine, retriever, rcfg: RaLMConfig,
                 encoder: Optional[ContextEncoder] = None, chunk_len: int = 64,
                 persistent_cache: bool = False,
                 shared_cache: Optional[SharedRetrievalCache] = None):
        if persistent_cache and shared_cache is None:
            shared_cache = SharedRetrievalCache(capacity=rcfg.cache_capacity)
        super().__init__(engine, retriever, rcfg, encoder, chunk_len,
                         shared_cache=shared_cache)
        self._pool = ThreadPoolExecutor(max_workers=1) \
            if rcfg.async_verification else None

    def serve(self, prompt: Sequence[int]) -> ServeResult:
        eng, r, rcfg = self.engine, self.retriever, self.rcfg
        eng.stats.reset()
        r0c, r0q, r0t = r.stats.calls, r.stats.queries, r.stats.time
        rs = self._new_request_state()
        res = rs.res
        t0 = time.perf_counter()

        eng.start(list(prompt)[-rcfg.max_prompt_len:])
        # Algorithm 1 line 4: initial retrieval populates the cache (prefetched)
        q0 = self._query()
        ids0, s0 = self._retrieve_batch([q0], max(rcfg.prefetch_top_k, 1))
        rs.analytic += r.stats.model_latency(1)
        self._cache_insert(rs.cache, ids0[0])
        self._shared_put([q0], ids0, s0)

        # NB: a pending carry (async overlap's extra speculative step) is an
        # UNVERIFIED speculative stride — the loop must not exit on budget/EOS
        # until it has been verified (and corrected if wrong), or output
        # preservation breaks on the final stride.
        while not self._done() or rs.carry:
            stride = rs.stride(rcfg)
            rs.begin_round()
            while len(rs.specs) < max(stride, 1) and not self._done():
                snap, q, did, a = self._spec_step(rs.cache)
                rs.record_step(snap, q, did, a)
                rs.analytic += a
                if rs.os3:
                    rs.os3.record_speculation(a)
            if not rs.specs:
                break
            res.spec_steps += len(rs.specs)
            res.strides.append(len(rs.specs))

            if self._pool is not None:
                fut = self._pool.submit(self._verify, rs.queries)
                # asynchronous extra speculation step (paper Figure 3) — adaptive:
                # only speculate while verification is actually pending. When the
                # retriever is cheaper than one speculation step (ADR), the extra
                # step is pure downside (paper Table 4 observes exactly this: +A
                # *hurts* ADR); waiting out the short verification costs less.
                extra = None
                b_est = self.retriever.stats.model_latency(len(rs.queries))
                a_est = sum(rs.a_times) / max(len(rs.a_times), 1)
                if (not fut.done() and b_est > rcfg.async_gate_ratio * a_est
                        and not self._done()):
                    extra = self._spec_step(rs.cache)
                gt_ids, b_lat, b_model = fut.result()
                # analytic ideal (paper §4): the verification latency hides behind
                # the extra speculation step — the round pays max(a_extra, b), and the
                # extra step's own a is *not* double-counted when carried over.
                rs.analytic += max(extra[3], b_model) if extra is not None else b_model
            else:
                gt_ids, b_lat, b_model = self._verify(rs.queries)
                rs.analytic += b_model
                extra = None

            # cache update: top-1 or top-k (prefetch) per verified query
            for row in gt_ids:
                self._cache_insert(rs.cache, row[:max(rcfg.prefetch_top_k, 1)])

            m = first_mismatch(rs.specs, gt_ids)
            if rs.os3:
                rs.os3.record_verification(b_model, len(rs.specs), m)
            res.rounds += 1

            if m < len(rs.specs):                   # mis-speculation: rollback
                res.mismatches += 1
                if extra is not None:               # extra step is invalid too
                    res.carry_invalidations += 1
                    extra = None
                self.engine.restore(rs.snaps[m])
                tc = time.perf_counter()
                self.engine.set_doc(self._doc(gt_ids[m, 0]))
                self.engine.gen(min(self.rcfg.generation_stride, self._budget()))
                rs.analytic += time.perf_counter() - tc
            if extra is not None:
                rs.carry = [extra]
                res.carry_steps += 1
                if rs.os3:
                    rs.os3.record_speculation(extra[3])

        res.tokens = list(eng.generated)
        res.wall_time = time.perf_counter() - t0
        res.analytic_time = rs.analytic
        res.gen_time = eng.stats.gen_time
        res.retrieval_time = r.stats.time - r0t
        res.kb_calls = r.stats.calls - r0c
        res.kb_queries = r.stats.queries - r0q
        return res

    # ---- helpers ----------------------------------------------------------------------
    def _spec_step(self, cache):
        """One speculative retrieval + generation stride. Returns
        (snapshot, query, speculated_doc_id, latency)."""
        t0 = time.perf_counter()
        snap = self.engine.snapshot()
        q = self._query()
        ids, _ = cache.retrieve(q, 1)
        did = int(ids[0])
        if did >= 0:
            self.engine.set_doc(self._doc(did))
        # did < 0 (cold cache) keeps the previous doc; verification will correct.
        self.engine.gen(min(self.rcfg.generation_stride, self._budget()))
        return snap, q, did, time.perf_counter() - t0

    def _verify(self, queries):
        """Batched KB retrieval (the verification step).

        Returns (ids, wall_latency, modeled_latency) — the modeled value follows the
        paper's §A.1 batched-latency shape (see RetrieverStats) and feeds the
        analytic timeline + OS^3; wall-clock always reported alongside.

        Runs on the async worker thread when async verification is on, so the
        shared-tier publish below relies on SharedRetrievalCache's lock."""
        t0 = time.perf_counter()
        k = max(self.rcfg.prefetch_top_k, 1)
        ids, scores = self._retrieve_batch(queries, k)
        self._shared_put(queries, ids, scores)
        return ids, time.perf_counter() - t0, \
            self.retriever.stats.model_latency(len(queries))
