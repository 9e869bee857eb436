"""Synthetic retrieval corpus and queries (host-side numpy).

``synthetic_corpus`` and ``make_queries`` are copied byte for byte from the
reference package: their RNG call order is what makes the corpus, so the port
and the reference index the same documents for the same seed.
"""
from __future__ import annotations

import hashlib

import numpy as np


def _rng(seed) -> np.random.Generator:
    if isinstance(seed, str):
        seed = int(hashlib.sha1(seed.encode()).hexdigest()[:8], 16)
    return np.random.default_rng(seed)


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
