"""The general traffic generator of a closed loop: ``clients`` callers that
each wait for their reply, served as one group of ``clients`` requests at a
time (the fixed-group fleet returns a group at once), the next group sent
when the last returns.

A mix file gives the prompt source and its lengths. Every seed gets the same
multiset of prompt lengths, ``block`` lengths evenly spaced over
[min_tokens, max_tokens] per block of requests, in an order drawn from the
seed; only the order and the tokens change with the seed, so the work of a
window does not. Prompt sources:

  * ``heldout_span``: a span of the corpus's held-out text (KNN-LM: text
    of the datastore's topics that is not the datastore's own, so that no
    context of a prompt is a key of the store);
  * ``qa_fewshot``: few-shot open-domain QA: exemplar text from random
    passages, then a question of ``question_min``..``question_max`` words
    drawn from a target passage (as the port's ``make_queries`` draws them).
"""
from __future__ import annotations

import numpy as np


def _lengths(spec: dict, block: int) -> np.ndarray:
    return np.linspace(spec["min_tokens"], spec["max_tokens"], block).round().astype(np.int64)


def _prompt(spec: dict, corpus, rng: np.random.Generator, n: int) -> list:
    src = spec["source"]
    if src == "heldout_span":
        stream = corpus.heldout
        start = int(rng.integers(0, len(stream) - n - 1))
        return stream[start:start + n].tolist()
    if src == "qa_fewshot":
        passages = corpus.passages
        P, L = passages.shape
        target = passages[int(rng.integers(0, P))]
        q_len = int(rng.integers(spec["question_min"], spec["question_max"] + 1))
        question = target[rng.integers(0, L, size=q_len)]
        need = n - q_len
        shots = passages[rng.integers(0, P, size=-(-need // L))].reshape(-1)[:need]
        return np.concatenate([shots, question]).tolist()
    raise ValueError(f"unknown prompt source {src!r}")


def groups(mix: dict, corpus, seed: int):
    """Endless groups of requests: each a list of ``clients`` (prompt tokens,
    new tokens) pairs."""
    rng = np.random.default_rng([seed, 0x7A11])
    spec, block, clients = mix["prompt"], int(mix["block"]), int(mix["clients"])
    base = _lengths(spec, block)
    pending: list = []
    while True:
        if len(pending) < clients:
            pending.extend(int(n) for n in rng.permutation(base))
        lens, pending = pending[:clients], pending[clients:]
        yield [(_prompt(spec, corpus, rng, n), int(mix["max_new"])) for n in lens]
