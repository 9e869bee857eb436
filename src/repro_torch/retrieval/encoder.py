"""Context encoder — the DPR stand-in.

A deterministic bag-of-embeddings encoder: fixed (seeded) embedding table, recency-
weighted mean over the last ``window`` tokens, L2-normalized. It plays DPR's role
exactly as the paper's pipeline needs it: a query embedding that drifts smoothly with
the generation context (temporal locality) and matches the document-key space.
"""
from __future__ import annotations

import numpy as np


class ContextEncoder:
    def __init__(self, vocab_size: int, d: int = 64, window: int = 32,
                 decay: float = 0.95, seed: int = 13):
        g = np.random.default_rng(seed)
        self.table = g.standard_normal((vocab_size, d), dtype=np.float32)
        self.table /= np.linalg.norm(self.table, axis=1, keepdims=True)
        self.d = d
        self.window = window
        self.decay = decay

    def encode(self, tokens) -> np.ndarray:
        """tokens: sequence of ints -> (d,) unit vector."""
        toks = np.asarray(tokens, np.int64)[-self.window:]
        if toks.size == 0:
            return np.zeros((self.d,), np.float32)
        w = self.decay ** np.arange(len(toks) - 1, -1, -1, dtype=np.float32)
        v = (self.table[toks] * w[:, None]).sum(0)
        n = np.linalg.norm(v)
        return (v / n).astype(np.float32) if n > 0 else v.astype(np.float32)

    def encode_batch(self, token_seqs) -> np.ndarray:
        return np.stack([self.encode(t) for t in token_seqs])

    def encode_doc(self, tokens) -> np.ndarray:
        """Document key: unweighted normalized mean (order-free, like DPR doc tower)."""
        toks = np.asarray(tokens, np.int64)
        v = self.table[toks].mean(0)
        n = np.linalg.norm(v)
        return (v / n).astype(np.float32) if n > 0 else v.astype(np.float32)
