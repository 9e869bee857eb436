"""Retrievers (the port's ``repro.retrieval.retrievers``): the three the paper
evaluates.

  * ExactDenseRetriever (EDR) — brute-force inner product over the flat index.
                                Scoring is delegated to a
                                :mod:`repro_torch.retrieval.backends` object:
                                'numpy' (flat BLAS scan) or 'kernel' (the CUDA
                                dense top-k, KB resident on the device) —
                                byte-identical under the canonical tie order —
                                and their int8 siblings 'int8' / 'int8-kernel'
                                (identical to each other, recall@k >= 0.95).
  * IVFRetriever        (ADR) — k-means coarse quantizer + nprobe cluster scan.
                                Centroid scoring stays host-side; the
                                per-bucket document scan delegates to the
                                same backends (``search_gathered``).
  * BM25Retriever       (SR)  — bag-of-words over the SparseKB, numpy on the
                                host (neither package has a kernel for it).

All retrievers expose:  retrieve(queries, k) -> (ids (B,k) int64, scores (B,k)).
``queries`` is (B, d) embeddings for dense retrievers, a list of term-lists for BM25.
The wall-clock timing + :class:`RetrieverStats` bookkeeping lives ONCE in
:class:`_TimedRetriever`; subclasses implement only the pure scan.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from repro_torch import trace
from repro_torch.retrieval.backends import (DenseSearchBackend, canonical_topk,
                                            make_backend)
from repro_torch.retrieval.kb import DenseKB, SparseKB


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
        with trace.span("kb.call", B=len(queries), k=k):
            t0 = time.perf_counter()
            ids, scores = self._search(queries, k)
            self.stats.add(len(queries), time.perf_counter() - t0, warmup=warmup)
        return ids, scores


class ExactDenseRetriever(_TimedRetriever):
    """EDR: exact scan, execution strategy chosen by the backend layer.

    ``backend`` is a :mod:`repro_torch.retrieval.backends` name (one of
    ``BACKENDS``) or an already-built backend object (one backend may serve
    an EDR and an ADR retriever, so the KB sits on the device once);
    ``device`` is where the kernel backends keep the KB (default: CUDA);
    ``mesh_shards`` is the sharded backends' shard count (0: one shard a
    visible card)."""

    name = "EDR"

    def __init__(self, kb: DenseKB, backend="numpy", device=None, mesh_shards: int = 0):
        self.kb = kb
        self.backend: DenseSearchBackend = (
            backend if not isinstance(backend, str)
            else make_backend(backend, kb.embeddings, device=device,
                              n_shards=mesh_shards or None))
        self.stats = RetrieverStats("const")

    def _cold_shape(self, B: int, k: int) -> bool:
        return self.backend.cold_shape(B, k)

    def _search(self, queries, k):
        return self.backend.search(queries, k)

    def keys_of(self, ids) -> np.ndarray:
        return self.kb.embeddings[np.asarray(ids, np.int64)]


class IVFRetriever(_TimedRetriever):
    """ADR: k-means coarse quantizer (host-side centroid scan) + nprobe bucket
    scan, the document scoring of which is delegated to the backend layer —
    the same execution strategies as EDR (int8 quantized included), via
    :meth:`~repro_torch.retrieval.backends.DenseSearchBackend.search_gathered`
    over the fixed-shape padded bucket gather. ``backend``, ``device`` and
    ``mesh_shards`` mean exactly what they do on :class:`ExactDenseRetriever`. The k-means, the
    bucket table and the candidate matrix are the reference's, computed the
    same way in numpy, so they come out equal to its own."""

    name = "ADR"

    def __init__(self, kb: DenseKB, n_clusters: int = 64, nprobe: int = 4,
                 iters: int = 8, seed: int = 3, backend="numpy", device=None,
                 mesh_shards: int = 0):
        self.kb = kb
        self.nprobe = nprobe
        self.stats = RetrieverStats("linear_intercept")
        self.backend: DenseSearchBackend = (
            backend if not isinstance(backend, str)
            else make_backend(backend, kb.embeddings, device=device,
                              n_shards=mesh_shards or None))
        g = np.random.default_rng(seed)
        X = kb.embeddings
        self.centroids = X[g.choice(X.shape[0], n_clusters, replace=False)].copy()
        for _ in range(iters):                                # Lloyd iterations
            assign = np.argmax(X @ self.centroids.T, axis=1)
            for c in range(n_clusters):
                pts = X[assign == c]
                if len(pts):
                    v = pts.mean(0)
                    self.centroids[c] = v / max(np.linalg.norm(v), 1e-9)
        assign = np.argmax(X @ self.centroids.T, axis=1)
        self.buckets = [np.where(assign == c)[0] for c in range(n_clusters)]
        self._build_pads()

    def _build_pads(self) -> None:
        """Fixed-shape bucket table for the vectorized probe: row c holds
        bucket c's doc ids padded with -1 to the longest bucket, so a batch's
        candidate sets are ONE gather ``_bucket_pad[cs]`` of shape
        (B, nprobe, Lmax) — no per-query Python concatenation."""
        L = max(max((len(bk) for bk in self.buckets), default=1), 1)
        self._bucket_pad = np.full((len(self.buckets), L), -1, np.int64)
        for c, bk in enumerate(self.buckets):
            self._bucket_pad[c, :len(bk)] = bk
        self._bucket_len = np.asarray([len(bk) for bk in self.buckets],
                                      np.int64)

    def _ensure_exec(self) -> None:
        """Backfill execution state on instances restored without __init__
        (an index cached by a benchmark and rebuilt via __new__)."""
        if not hasattr(self, "_bucket_pad"):
            self._build_pads()
        if not hasattr(self, "backend"):
            self.backend = make_backend("numpy", self.kb.embeddings)

    def _cand_width(self, k: int) -> int:
        """The fixed candidate width C of the gathered scan: nprobe x Lmax
        from the index, widened to k so fallback/pad slots fit. (nprobe
        clamps to the cluster count, as the probe's argsort slice does
        implicitly.)"""
        nprobe = min(self.nprobe, len(self.buckets))
        return max(self._bucket_pad.shape[1] * nprobe,
                   max(min(k, self.kb.size), 1), k)

    def _cold_shape(self, B: int, k: int) -> bool:
        self._ensure_exec()
        return self.backend.cold_shape_gathered(B, self._cand_width(k), k)

    def _gather_candidates(self, queries: np.ndarray,
                           k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Host-side probe: score centroids, gather the probed buckets' padded
        id rows into the fixed-shape (B, C) candidate matrix, then normalize
        each row to the backend contract — ids sorted ascending, -1 pads last
        (id-sorted columns are what make every backend's positional tie break
        the canonical id-ascending order). Queries whose probes come up empty
        fall back to the first ``min(k, kb.size)`` docs. Returns
        ``(cand, counts)``; counts = real candidates per row."""
        B = queries.shape[0]
        cs = np.argsort(-(queries @ self.centroids.T), axis=1)[:, :self.nprobe]
        cand = self._bucket_pad[cs].reshape(B, -1)        # (B, nprobe*Lmax)
        counts = self._bucket_len[cs].sum(1)              # real cands per row
        F = max(min(k, self.kb.size), 1)
        if cand.shape[1] < max(F, k):                     # room for fallback/pad
            cand = np.pad(cand, ((0, 0), (0, max(F, k) - cand.shape[1])),
                          constant_values=-1)
        empty = counts == 0
        if empty.any():                                   # fallback candidates
            cand[empty] = -1
            cand[empty, :F] = np.arange(F)
            counts = np.where(empty, F, counts)
        big = np.iinfo(np.int64).max
        cand = np.sort(np.where(cand < 0, big, cand), axis=1)
        cand[cand == big] = -1
        return cand, counts

    def _search(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized nprobe scan, document scoring on the backend: the padded
        fixed-shape candidate gather goes down to ``backend.search_gathered``,
        which returns the canonical (score desc, id asc) top-k over each
        row's real candidates with (-1, -inf) pads.

        Semantics beyond the backend contract live here: queries whose probes
        come up empty fall back to the first ``min(k, kb.size)`` docs, and
        rows with fewer than k candidates pad by repeating their last real
        (id, score). Because the padded shape is fixed by the index
        (nprobe x Lmax), a batched call is byte-identical to the same queries
        issued one at a time."""
        self._ensure_exec()
        cand, counts = self._gather_candidates(queries, k)
        ids, sc = self.backend.search_gathered(queries, cand, k)
        k2 = ids.shape[1]                                 # min(k, C) == k here
        kk = np.minimum(counts, k2)                       # real hits per row
        fill = np.arange(k2)[None, :] >= kk[:, None]      # pad: repeat last
        last = np.maximum(kk - 1, 0)[:, None]
        ids = np.where(fill, np.take_along_axis(ids, last, axis=1), ids)
        sc = np.where(fill, np.take_along_axis(sc, last, axis=1), sc)
        return ids.astype(np.int64), sc.astype(np.float32)

    def keys_of(self, ids) -> np.ndarray:
        return self.kb.embeddings[np.asarray(ids, np.int64)]


class BM25Retriever(_TimedRetriever):
    """SR: BM25 over a SparseKB."""

    name = "SR"

    def __init__(self, kb: SparseKB):
        self.kb = kb
        self.stats = RetrieverStats("const")

    def _prep(self, queries):
        if queries and isinstance(queries[0], (int, np.integer)):
            return [queries]
        return queries

    def _search(self, queries: List[list], k: int) -> Tuple[np.ndarray, np.ndarray]:
        # canonical tie order (score desc, id asc) like the dense backends —
        # the sparse speculation cache retrieves canonically, so under exact
        # BM25 ties both sides name the same doc (no spurious rollback)
        s = np.stack([self.kb.score(q) for q in queries])
        return canonical_topk(s, k)

    def keys_of(self, ids) -> np.ndarray:
        """Sparse 'keys' are the per-doc term arrays."""
        return self.kb.terms[np.asarray(ids, np.int64)]
