"""Data (host-side numpy): the training sources and the synthetic retrieval
corpus.

  * ``SyntheticLM``      — deterministic pseudo-random token stream with planted
                           n-gram structure (so loss actually falls during the
                           end-to-end example run).
  * ``CorpusLM``         — tokenized document corpus packed into fixed-length
                           training sequences.
  * ``synthetic_corpus`` and ``make_queries`` — the corpus the retrieval stack
                           indexes and the queries served over it.

All four are copied byte for byte from the reference package: their RNG call
order is what makes the data, so the port and the reference train on the same
batches and index the same documents for the same seed. The training sources
yield {"tokens": (B, S) int32, "labels": (B, S) int32}.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Iterator

import numpy as np


def _rng(seed) -> np.random.Generator:
    if isinstance(seed, str):
        seed = int(hashlib.sha1(seed.encode()).hexdigest()[:8], 16)
    return np.random.default_rng(seed)


@dataclass
class SyntheticLM:
    """Markov-ish synthetic stream: each vocab id prefers a successor, so a model can
    reduce loss well below uniform. Deterministic per (seed, step)."""

    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0

    def __post_init__(self):
        g = _rng(self.seed)
        self.successor = g.integers(0, self.vocab_size, size=self.vocab_size)

    def batch(self, step: int) -> dict:
        g = _rng(self.seed * 1_000_003 + step)
        B, S = self.batch_size, self.seq_len
        toks = np.empty((B, S), np.int32)
        toks[:, 0] = g.integers(0, self.vocab_size, size=B)
        noise = g.random((B, S)) < 0.25
        rand = g.integers(0, self.vocab_size, size=(B, S))
        for t in range(1, S):
            nxt = self.successor[toks[:, t - 1]]
            toks[:, t] = np.where(noise[:, t], rand[:, t], nxt)
        return {"tokens": toks, "labels": toks.copy()}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class CorpusLM:
    """Pack tokenized documents into contiguous training sequences."""

    def __init__(self, docs_tokens: list, seq_len: int, batch_size: int,
                 eos_id: int = 0, seed: int = 0):
        self.seq = seq_len
        self.bs = batch_size
        stream = []
        for d in docs_tokens:
            stream.extend(d)
            stream.append(eos_id)
        self.stream = np.asarray(stream, np.int32)
        self.g = _rng(seed)

    def batch(self, step: int) -> dict:
        g = _rng(step)
        n = len(self.stream) - self.seq - 1
        starts = g.integers(0, max(n, 1), size=self.bs)
        toks = np.stack([self.stream[s:s + self.seq] for s in starts])
        return {"tokens": toks, "labels": toks.copy()}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


_TOPIC_WORDS = 64     # words per topic cluster
_WORDS_PER_DOC = 48


def synthetic_corpus(n_docs: int, vocab_size: int, *, n_topics: int = 32,
                     seed: int = 7) -> list:
    """Wikipedia-like synthetic corpus with topical clustering: documents in the same
    topic share a skewed word distribution, giving retrieval the temporal/spatial
    locality structure the paper's cache exploits. Consecutive doc ids within a topic
    are 'consecutive passages' (spatial locality for KNN-LM prefetch)."""
    g = _rng(seed)
    topic_vocab = [
        g.integers(2, vocab_size, size=_TOPIC_WORDS) for _ in range(n_topics)
    ]
    docs = []
    for i in range(n_docs):
        topic = (i * n_topics) // n_docs          # consecutive docs share topics
        tv = topic_vocab[topic]
        # 80% topical words, 20% background
        k = _WORDS_PER_DOC
        topical = tv[g.integers(0, len(tv), size=int(k * 0.8))]
        background = g.integers(2, vocab_size, size=k - len(topical))
        words = np.concatenate([topical, background])
        g.shuffle(words)
        docs.append(words.astype(np.int32).tolist())
    return docs


def make_queries(docs: list, n_queries: int, *, seed: int = 11) -> list:
    """Question-like queries: a few words sampled from a (random) target doc plus
    noise — mimics context-dependent queries drifting within a topic."""
    g = _rng(seed)
    qs = []
    for _ in range(n_queries):
        d = docs[g.integers(0, len(docs))]
        take = g.integers(3, 8)
        idx = g.integers(0, len(d), size=take)
        qs.append([d[i] for i in idx])
    return qs
