"""Speculation caches: the per-request local cache (paper §3, Figure 2) and the
fleet-scale shared tier in front of it (ROADMAP item 1).

Not exact-match caches: retrieval from the local cache uses the *same scoring
metric* as the knowledge-base retriever, over the (much smaller) set of cached
entries. This gives the paper's rank-preservation property: if the KB top-1
document for a query is present in the cache, cache retrieval returns exactly
that document (proved as a hypothesis property test in
tests/test_cache_properties.py).

DenseRetrievalCache  — keys are embeddings, score = inner product (EDR/ADR/KNN-LM).
SparseRetrievalCache — keys are per-doc term arrays; score = BM25 with the *global*
                       corpus statistics (idf, avgdl) captured at construction, so the
                       cache score of a doc equals its KB score exactly.

Both caches retrieve under the CANONICAL tie order — score descending, then id
ascending — the same contract the retrieval-backend layer
(repro_torch.retrieval.backends) guarantees. Under exact score ties the cache
therefore speculates the very document the KB would verify, instead of wasting
a rollback on an equally-scored neighbor (tests/test_cache_properties.py pins
this against FlatBackend on tie-heavy KBs).

SharedRetrievalCache — the cross-request tier: a thread-safe, in-process LRU
map from *verified queries* to their KB results, shared by every request a
server (or a whole fleet) serves. Lookup is exact-hit on the query bytes
first, then approximate-hit on embedding inner product (dense queries only).
It is strictly a *speculation source*: batched verification still confirms
every emitted document against the KB, so output preservation is untouched —
a shared hit can only save (or waste) a rollback, never change a token.
SharedCacheView is the per-request read-through view RequestState holds:
shared tier first (exact → approximate), this request's own local cache as
the fallback, with the local cache's insert/values_of API passed through
unchanged.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.retrieval.kb import SparseKB


def query_key(query) -> bytes:
    """Canonical byte key of a verification query: dense embeddings key on
    their float32 bytes, sparse term lists on their int64 bytes. A type tag
    keeps the two families from ever colliding in one shared tier."""
    if isinstance(query, np.ndarray):
        return b"d" + np.ascontiguousarray(query, np.float32).tobytes()
    return b"s" + np.asarray(list(query), np.int64).tobytes()


def _canonical_top(ids_all: np.ndarray, s: np.ndarray, kk: int):
    """Indices of the top-kk entries under the canonical tie order (score
    desc, id asc). The caches score a *slot-compressed* LRU view, so the
    positional tie break the backends use would resolve ties by LRU slot
    order — ties must break on the actual doc ids instead."""
    return np.lexsort((ids_all, -s))[:kk]


class DenseRetrievalCache:
    def __init__(self, d: int, capacity: int = 4096):
        self.capacity = capacity
        self.d = d
        self._keys = np.zeros((capacity, d), np.float32)
        self._ids = np.full((capacity,), -1, np.int64)
        self._values = np.full((capacity,), -1, np.int64)   # optional payload
        self._order: OrderedDict = OrderedDict()            # id -> slot (LRU)
        self._free = list(range(capacity - 1, -1, -1))
        self.size = 0

    def __contains__(self, doc_id) -> bool:
        return int(doc_id) in self._order

    def insert(self, ids, keys, values=None) -> None:
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        keys = np.atleast_2d(np.asarray(keys, np.float32))
        vals = (np.atleast_1d(np.asarray(values, np.int64))
                if values is not None else np.full(len(ids), -1, np.int64))
        for i, did in enumerate(ids):
            did = int(did)
            if did in self._order:                          # refresh LRU + payload
                # a re-insert may carry a fresh key/value (KNN-LM value
                # payloads): leaving the old slot contents behind values_of
                # would serve stale data
                slot = self._order[did]
                self._keys[slot] = keys[i]
                self._values[slot] = vals[i]
                self._order.move_to_end(did)
                continue
            if not self._free:                              # evict LRU
                old, slot = self._order.popitem(last=False)
                self._free.append(slot)
                self.size -= 1
            slot = self._free.pop()
            self._keys[slot] = keys[i]
            self._ids[slot] = did
            self._values[slot] = vals[i]
            self._order[did] = slot
            self.size += 1

    def retrieve(self, query: np.ndarray, k: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        """-> (ids (k,), scores (k,)); ids are -1 if the cache holds < k entries."""
        if self.size == 0:
            return np.full((k,), -1, np.int64), np.full((k,), -np.inf, np.float32)
        slots = np.fromiter(self._order.values(), np.int64, len(self._order))
        ids_all = self._ids[slots]
        s = self._keys[slots] @ np.asarray(query, np.float32)
        kk = min(k, len(slots))
        top = _canonical_top(ids_all, s, kk)
        ids = ids_all[top]
        sc = s[top]
        for did in ids:                                     # LRU touch
            self._order.move_to_end(int(did))
        if kk < k:
            ids = np.pad(ids, (0, k - kk), constant_values=-1)
            sc = np.pad(sc, (0, k - kk), constant_values=-np.inf)
        return ids, sc

    def values_of(self, ids) -> np.ndarray:
        out = []
        for did in np.atleast_1d(ids):
            slot = self._order.get(int(did), None)
            out.append(self._values[slot] if slot is not None else -1)
        return np.asarray(out, np.int64)


class SparseRetrievalCache:
    """BM25-scored cache. Stores per-doc term arrays; corpus stats come from the KB
    (global, fixed) so local scores == KB scores for any cached doc."""

    def __init__(self, kb: SparseKB, capacity: int = 4096):
        self.kb = kb
        self.capacity = capacity
        L = kb.terms.shape[1]
        self._terms = np.full((capacity, L), -1, np.int32)
        self._dl = np.zeros((capacity,), np.float32)
        self._ids = np.full((capacity,), -1, np.int64)
        self._order: OrderedDict = OrderedDict()
        self._free = list(range(capacity - 1, -1, -1))
        self.size = 0

    def __contains__(self, doc_id) -> bool:
        return int(doc_id) in self._order

    def insert(self, ids, keys=None, values=None) -> None:
        for did in np.atleast_1d(np.asarray(ids, np.int64)):
            did = int(did)
            if did in self._order:
                # terms/doc_len are re-read from the (immutable) KB, so unlike
                # the dense cache there is no payload to refresh — LRU only
                self._order.move_to_end(did)
                continue
            if not self._free:
                _, slot = self._order.popitem(last=False)
                self._free.append(slot)
                self.size -= 1
            slot = self._free.pop()
            self._terms[slot] = self.kb.terms[did]
            self._dl[slot] = self.kb.doc_len[did]
            self._ids[slot] = did
            self._order[did] = slot
            self.size += 1

    def retrieve(self, query_terms, k: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        if self.size == 0:
            return np.full((k,), -1, np.int64), np.full((k,), -np.inf, np.float32)
        slots = np.fromiter(self._order.values(), np.int64, len(self._order))
        ids_all = self._ids[slots]
        T = self._terms[slots]
        dl = self._dl[slots]
        norm = self.kb.k1 * (1 - self.kb.b + self.kb.b * dl / self.kb.avgdl)
        s = np.zeros(len(slots), np.float32)
        for t in query_terms:
            idf = self.kb.idf.get(int(t))
            if idf is None:
                continue
            tf = (T == int(t)).sum(1).astype(np.float32)
            s += idf * tf * (self.kb.k1 + 1) / (tf + norm)
        kk = min(k, len(slots))
        top = _canonical_top(ids_all, s, kk)
        ids = ids_all[top]
        sc = s[top]
        for did in ids:
            self._order.move_to_end(int(did))
        if kk < k:
            ids = np.pad(ids, (0, k - kk), constant_values=-1)
            sc = np.pad(sc, (0, k - kk), constant_values=-np.inf)
        return ids, sc


class SharedRetrievalCache:
    """Fleet-scale shared speculation tier: verified query -> KB result, LRU.

    At fleet scale query distributions are heavy-tailed and identical
    verification queries recur constantly across requests; this tier lets any
    request speculate from any other request's *verified* KB results. Lookup:

      1. exact hit  — the query's canonical bytes (:func:`query_key`) match a
                      stored verified query: return its KB top-k verbatim.
      2. approx hit — (dense only) the query's inner product against a stored
                      query embedding reaches ``approx_threshold``: return
                      that neighbor's result as the speculation. Queries are
                      L2-normalized here, so the threshold is a cosine.

    Results stored here came out of real (batched) verification calls and are
    only ever used to *speculate* — verification still confirms every emitted
    document, so a stale or approximate hit costs at most a rollback and can
    never change served tokens.

    Thread-safe by a single lock around all state: the async fleet's
    verification worker writes results while the main thread's overlapped
    speculation stride reads, and a server object may be shared across
    threads (the folded ``RaLMSpec(persistent_cache=True)`` path). Entries
    are O(k) ids/scores, so the lock hold times are tiny next to a scan.
    """

    def __init__(self, capacity: int = 65536, approx_threshold: float = 0.98,
                 approx: bool = True):
        self.capacity = max(int(capacity), 1)
        self.approx_threshold = float(approx_threshold)
        self.approx = approx
        self._lock = threading.Lock()
        self._order: OrderedDict = OrderedDict()     # key -> slot (LRU)
        self._results: List = [None] * self.capacity  # slot -> (ids, scores)
        self._slot_key: List = [None] * self.capacity  # slot -> key (evict)
        self._free = list(range(self.capacity - 1, -1, -1))
        self._qemb: Optional[np.ndarray] = None       # (capacity, d), lazy
        # stats ledger (read via stats(); guarded by the same lock)
        self.hits_exact = 0
        self.hits_approx = 0
        self.misses = 0
        self.puts = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._order)

    @staticmethod
    def _unit(q: np.ndarray) -> np.ndarray:
        q = np.asarray(q, np.float32)
        n = float(np.linalg.norm(q))
        return q / n if n > 0 else q

    def lookup(self, query) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """-> (ids, scores) copy of a stored verified result, or None. Exact
        byte hit first, then the approximate embedding tier."""
        key = query_key(query)
        dense = isinstance(query, np.ndarray)
        with self._lock:
            slot = self._order.get(key)
            if slot is not None:
                self._order.move_to_end(key)
                self.hits_exact += 1
                ids, sc = self._results[slot]
                return ids.copy(), sc.copy()
            if dense and self.approx and self._qemb is not None and self._order:
                slots = np.fromiter(self._order.values(), np.int64,
                                    len(self._order))
                sims = self._qemb[slots] @ self._unit(query)
                best = int(np.argmax(sims))
                if float(sims[best]) >= self.approx_threshold:
                    bkey = self._slot_key[slots[best]]
                    self._order.move_to_end(bkey)
                    self.hits_approx += 1
                    ids, sc = self._results[slots[best]]
                    return ids.copy(), sc.copy()
            self.misses += 1
            return None

    def put(self, query, ids, scores) -> None:
        """Store a *verified* KB result for ``query``. A duplicate put
        refreshes the stored payload (fresh prefetch depth / KNN values),
        mirroring the local caches' refresh-on-reinsert semantics."""
        key = query_key(query)
        dense = isinstance(query, np.ndarray)
        ids = np.asarray(ids, np.int64).reshape(-1).copy()
        scores = np.asarray(scores, np.float32).reshape(-1).copy()
        with self._lock:
            self.puts += 1
            slot = self._order.get(key)
            if slot is not None:
                self._results[slot] = (ids, scores)
                self._order.move_to_end(key)
                return
            if not self._free:
                old_key, slot = self._order.popitem(last=False)
                self._slot_key[slot] = None
                self._results[slot] = None
                self._free.append(slot)
                self.evictions += 1
            slot = self._free.pop()
            if dense and self.approx:
                q = np.asarray(query, np.float32).reshape(-1)
                if self._qemb is None:
                    self._qemb = np.zeros((self.capacity, q.shape[0]),
                                          np.float32)
                if q.shape[0] == self._qemb.shape[1]:
                    self._qemb[slot] = self._unit(q)
            self._results[slot] = (ids, scores)
            self._slot_key[slot] = key
            self._order[key] = slot

    def stats(self) -> dict:
        with self._lock:
            lookups = self.hits_exact + self.hits_approx + self.misses
            return dict(size=len(self._order), capacity=self.capacity,
                        hits_exact=self.hits_exact,
                        hits_approx=self.hits_approx, misses=self.misses,
                        lookups=lookups, puts=self.puts,
                        evictions=self.evictions,
                        hit_rate=(self.hits_exact + self.hits_approx)
                        / max(lookups, 1))

    def check_invariants(self) -> None:
        """Structural consistency (the concurrent stress test calls this):
        every LRU entry maps to a distinct live slot holding its key and a
        well-formed result; free slots are empty; counts balance."""
        with self._lock:
            slots = list(self._order.values())
            assert len(slots) == len(set(slots)), "slot aliased by two keys"
            assert len(slots) + len(self._free) == self.capacity
            assert len(slots) <= self.capacity
            for key, slot in self._order.items():
                assert self._slot_key[slot] == key
                ids, sc = self._results[slot]
                assert ids.shape == sc.shape and ids.ndim == 1
            for slot in self._free:
                assert self._results[slot] is None
                assert self._slot_key[slot] is None


class SharedCacheView:
    """RequestState's read-through view of the shared tier.

    Exposes the per-request cache API (retrieve / insert / values_of /
    __contains__), so the serving loops drive it exactly like a local cache:

        retrieve: shared tier (exact → approximate) → this request's local
                  cache — the hit path in docs/architecture.md; a full miss
                  speculates cold (did = -1) and verification corrects.
        writes:   pass through to the LOCAL cache only. Shared-tier inserts
                  happen where verified KB results are born (the servers'
                  verification paths), never from per-request doc inserts —
                  the tier maps queries to results, not docs to keys.
    """

    def __init__(self, local, shared: SharedRetrievalCache):
        self.local = local
        self.shared = shared

    @property
    def size(self) -> int:
        return self.local.size

    def __contains__(self, doc_id) -> bool:
        return doc_id in self.local

    def insert(self, ids, keys=None, values=None) -> None:
        self.local.insert(ids, keys, values)

    def values_of(self, ids) -> np.ndarray:
        return self.local.values_of(ids)

    def retrieve(self, query, k: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        hit = self.shared.lookup(query)
        if hit is None:
            return self.local.retrieve(query, k)
        ids, sc = hit
        kk = min(k, len(ids))
        out_ids = np.full((k,), -1, np.int64)
        out_sc = np.full((k,), -np.inf, np.float32)
        out_ids[:kk] = ids[:kk]
        out_sc[:kk] = sc[:kk]
        return out_ids, out_sc
