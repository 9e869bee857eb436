"""Retrievers (the port's ``repro.retrieval.retrievers``, EDR only).

  * ExactDenseRetriever (EDR) — brute-force inner product over the flat index.
                                Scoring is delegated to a
                                :mod:`repro_torch.retrieval.backends` object:
                                'numpy' (flat BLAS scan) or 'kernel' (the CUDA
                                dense top-k, KB resident on the device) —
                                byte-identical under the canonical tie order.

ADR (``IVFRetriever``) and SR (``BM25Retriever``) are later slices; only the
``BM25Retriever`` name exists here, for the serving core's sparse/dense check.

All retrievers expose:  retrieve(queries, k) -> (ids (B,k) int64, scores (B,k)).
The wall-clock timing + :class:`RetrieverStats` bookkeeping lives ONCE in
:class:`_TimedRetriever`; subclasses implement only the pure scan.
"""
from __future__ import annotations

import threading
import time
from typing import Optional, Tuple

import numpy as np

from repro_torch.retrieval.backends import DenseSearchBackend, make_backend
from repro_torch.retrieval.kb import DenseKB


class RetrieverStats:
    """Per-retriever call ledger (the R component of the paper's G/R decomposition)
    plus a batched-latency MODEL with the paper's §A.1 shape.

    This container has a single CPU core, so a batch-B matmul genuinely costs ~B x
    a GEMV (compute-bound); on the paper's hardware (FAISS on A10 + 15 CPUs) batched
    retrieval is nearly constant-cost for EDR/SR and linear-with-intercept for ADR.
    The model reproduces those shapes, calibrated online from the *measured*
    single-query unit cost, and feeds the benchmarks' 'modeled' timeline — exactly
    the strategy the paper itself uses for async verification under the GIL.
    Wall-clock numbers are always reported alongside.

      EDR/SR: t(B) = unit * (1 + 0.05 * (B - 1))      (near-constant total)
      ADR:    t(B) = unit * (0.55 + 0.45 * B)          (linear, large intercept)

    Calibration hygiene: calls flagged ``warmup=True`` (a jitted backend's
    first call at a given shape — it pays the XLA compile) are counted in the
    call/query/time ledger but EXCLUDED from the ``_unit`` EMA, so the modeled
    timeline and the async overlap gate aren't skewed by compilation cost
    that paper hardware pays once at server start.

    Thread-safe: with async (pipelined) verification the fleet's worker thread
    calls ``add`` while the main thread reads ``model_latency`` for the overlap
    gate and the analytic timeline, so the counters and the ``_unit`` EMA are
    guarded by a (re-entrant: add -> model_latency) lock.
    """

    def __init__(self, kind: str = "const"):
        self.kind = kind
        self.calls = 0
        self.queries = 0
        self.time = 0.0
        self.modeled_time = 0.0
        self.warmup_calls = 0
        # fault-tolerance ledger, recorded by the serving layer's retry shell
        # (_ServerBase._retrieve_guarded): attempts that raised, attempts that
        # overran the per-call deadline, and calls that exhausted the whole
        # retry budget. Successful attempts land in calls/queries as usual;
        # raised attempts never reach add(), so calls counts completed scans.
        self.errors = 0
        self.timeouts = 0
        self.failed_calls = 0
        self._unit: Optional[float] = None
        self._lock = threading.RLock()

    def factor(self, B: int) -> float:
        if self.kind == "linear_intercept":
            return 0.55 + 0.45 * B
        return 1.0 + 0.05 * (B - 1)

    def add(self, n_queries: int, dt: float, warmup: bool = False):
        with self._lock:
            self.calls += 1
            self.queries += n_queries
            self.time += dt
            if warmup:
                # compile-polluted sample: keep it out of the unit calibration
                self.warmup_calls += 1
            # calibrate the unit cost from SINGLE-query calls only — on this
            # 1-core box a batch-B matmul costs ~B x the GEMV, which would
            # pollute the unit
            elif n_queries == 1:
                self._unit = (dt if self._unit is None
                              else 0.8 * self._unit + 0.2 * dt)
            elif self._unit is None:
                self._unit = dt / n_queries    # conservative bootstrap
            self.modeled_time += self.model_latency(n_queries)

    def model_latency(self, B: int) -> float:
        with self._lock:
            return (self._unit or 0.0) * self.factor(B)

    def record_failure(self, kind: str, final: bool = False) -> None:
        """One failed KB-call attempt: ``kind`` is 'timeout' (overran the
        per-call deadline) or 'error' (raised); ``final`` marks the attempt
        that exhausted the retry budget."""
        with self._lock:
            if kind == "timeout":
                self.timeouts += 1
            else:
                self.errors += 1
            if final:
                self.failed_calls += 1


class _TimedRetriever:
    """Shared retrieve() shell: input normalization, wall-clock timing, stats
    ledger, and per-shape warmup detection for jit-backed scans. Subclasses
    provide the pure scan in ``_search`` (and may override ``_prep``); the
    backend objects themselves stay measurement-free."""

    stats: RetrieverStats

    def _prep(self, queries):
        return np.atleast_2d(np.asarray(queries, np.float32))

    def _cold_shape(self, B: int, k: int) -> bool:
        """Will the next scan at this shape pay a one-time compile? Backed
        retrievers delegate to the backend, which owns the jit cache (so
        retrievers sharing a backend agree on what is warm)."""
        return False

    def _search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def retrieve(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        queries = self._prep(queries)
        warmup = self._cold_shape(len(queries), k)
        t0 = time.perf_counter()
        ids, scores = self._search(queries, k)
        self.stats.add(len(queries), time.perf_counter() - t0, warmup=warmup)
        return ids, scores


class ExactDenseRetriever(_TimedRetriever):
    """EDR: exact scan, execution strategy chosen by the backend layer.

    ``backend`` is a :mod:`repro_torch.retrieval.backends` name (one of
    ``BACKENDS``) or an already-built backend object; ``device`` is where the
    'kernel' backend keeps the KB (default: CUDA)."""

    name = "EDR"

    def __init__(self, kb: DenseKB, backend="numpy", device=None):
        self.kb = kb
        self.backend: DenseSearchBackend = (
            backend if not isinstance(backend, str)
            else make_backend(backend, kb.embeddings, device=device))
        self.stats = RetrieverStats("const")

    def _cold_shape(self, B: int, k: int) -> bool:
        return self.backend.cold_shape(B, k)

    def _search(self, queries, k):
        return self.backend.search(queries, k)

    def keys_of(self, ids) -> np.ndarray:
        return self.kb.embeddings[np.asarray(ids, np.int64)]


class BM25Retriever(_TimedRetriever):
    """SR over a SparseKB — ported with the SR slice (ROADMAP.md). The class
    exists so the serving core can tell sparse retrievers from dense ones."""

    name = "SR"

    def __init__(self, kb):
        raise NotImplementedError(
            "BM25Retriever (SR) is not ported yet; the port serves EDR")
