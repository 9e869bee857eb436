"""Knowledge-base containers shared by all retrievers."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.retrieval.encoder import ContextEncoder


@dataclass
class DenseKB:
    """Flat dense index: embeddings (N, d) + doc payloads."""

    embeddings: np.ndarray               # (N, d) float32, unit-norm
    docs: List[list]                     # token lists
    values: Optional[np.ndarray] = None  # per-entry payload (KNN-LM: next token)

    @property
    def size(self) -> int:
        return self.embeddings.shape[0]

    @classmethod
    def build(cls, docs: List[list], encoder: ContextEncoder) -> "DenseKB":
        emb = np.stack([encoder.encode_doc(d) for d in docs])
        return cls(embeddings=emb, docs=docs)


@dataclass
class SparseKB:
    """BM25 bag-of-words index: per-doc term arrays + corpus statistics.

    Term frequencies are computed on the fly against fixed-length term lists —
    TPU/JAX-friendly (no ragged CSR) and exactly reproducible in the local cache,
    which stores the same per-doc term arrays plus the *global* idf/avgdl (the paper's
    requirement that cache scores be computable locally with the same metric)."""

    terms: np.ndarray                    # (N, L) int32 padded with -1
    doc_len: np.ndarray                  # (N,)
    idf: dict                            # term -> idf  (computed once, global)
    avgdl: float
    docs: List[list]
    k1: float = 1.5
    b: float = 0.75

    @property
    def size(self) -> int:
        return self.terms.shape[0]

    @classmethod
    def build(cls, docs: List[list]) -> "SparseKB":
        N = len(docs)
        L = max(len(d) for d in docs)
        terms = np.full((N, L), -1, np.int32)
        dl = np.zeros((N,), np.float32)
        df: dict = {}
        for i, d in enumerate(docs):
            terms[i, :len(d)] = d
            dl[i] = len(d)
            for t in set(d):
                df[t] = df.get(t, 0) + 1
        idf = {t: float(np.log(1 + (N - c + 0.5) / (c + 0.5))) for t, c in df.items()}
        return cls(terms=terms, doc_len=dl, idf=idf, avgdl=float(dl.mean()),
                   docs=docs)

    def score(self, query_terms, sub: Optional[np.ndarray] = None) -> np.ndarray:
        """BM25 scores of ``query_terms`` against all docs (or a subset index).

        Vectorized over the query: repeated terms are deduped and unique
        terms' tf columns come out of batched ``(T[..., None] == terms).sum(1)``
        passes instead of a full (N, L) scan per term — term-chunked so the
        (N, L, chunk) boolean transient stays ~32MB however long the query
        is. Scores are bit-identical to the scalar loop: each unique term's
        BM25 contribution is computed with the same (scalar-idf, float32-tf)
        expression, then accumulated in the original query-occurrence order."""
        T = self.terms if sub is None else self.terms[sub]
        dl = self.doc_len if sub is None else self.doc_len[sub]
        scores = np.zeros(T.shape[0], np.float32)
        known = [int(t) for t in query_terms if int(t) in self.idf]
        if not known:
            return scores
        uniq = list(dict.fromkeys(known))      # dedupe, first-occurrence order
        norm = self.k1 * (1 - self.b + self.b * dl / self.avgdl)
        contrib = {}
        step = max(1, 32_000_000 // max(T.size, 1))
        for i in range(0, len(uniq), step):
            chunk = uniq[i:i + step]
            tf_all = (T[..., None] == np.asarray(chunk, T.dtype)).sum(1) \
                .astype(np.float32)            # (N, chunk): one pass per chunk
            for j, t in enumerate(chunk):
                tf = tf_all[:, j]
                contrib[t] = self.idf[t] * tf * (self.k1 + 1) / (tf + norm)
        for t in known:                        # same accumulation order as the
            scores += contrib[t]               # scalar loop (float-exact)
        return scores


def build_knn_datastore(stream: np.ndarray, encoder: ContextEncoder,
                        context: int = 16, stride: int = 1,
                        limit: Optional[int] = None) -> DenseKB:
    """KNN-LM datastore: key = embedding of leftward context, value = next token.
    Consecutive entries are consecutive training positions — the spatial locality the
    paper's next-n prefetch rule exploits.

    Vectorized: the decayed-window context embedding is a 16-tap FIR over the token
    embeddings, computed as `context` shifted adds over the whole stream — O(N*d)
    instead of a 1-per-entry python loop (needed for the 1M-entry benchmark store).
    """
    stream = np.asarray(stream, np.int64)
    N = len(stream) - context - 1
    idxs = np.arange(0, N, stride)
    if limit:
        idxs = idxs[:limit]
    E = encoder.table[stream]                                  # (len, d)
    S = np.zeros_like(E)
    for j in range(context):                                   # tap j: decay^j
        w = encoder.decay ** j
        # context window of entry i is stream[i : i+context]; last token weight 1
        S[context - 1:] += w * E[context - 1 - j: len(E) - j]
    # entry i's context ends at position i+context-1
    keys = S[idxs + context - 1]
    norms = np.linalg.norm(keys, axis=1, keepdims=True)
    keys = (keys / np.maximum(norms, 1e-9)).astype(np.float32)
    vals = stream[idxs + context].astype(np.int32)
    docs = [stream[i:i + context].tolist() for i in idxs]
    return DenseKB(embeddings=keys, docs=docs, values=vals)
