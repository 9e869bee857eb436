"""The comparison that decides ``correct`` must fail where it should, on the
CPU at a test size: the control (the plain reference in TF32, the precision
below the configuration's, put in the program's place) reads above a limit,
and a run with the timed path broken underneath comes out not correct, once
for each fault a serving cell can have.

    python -m pytest -q bench/tests
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bench.tests.tiny import run_tiny
from bench import cells

CELLS = ["knnlm-edr-c8", "ralm-edr-c8"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_a_limit(cell):
    out = run_tiny(cell, ctrl="tf32")
    assert out["correct"], out["checks"]
    limits = cells.find(cell).limits
    over = {k: out["readings"]["ctrl_" + k] for k in limits
            if out["readings"]["ctrl_" + k] > limits[k]["limit"]}
    assert over, out["readings"]
    assert out["ctrl_correct"] is False


def _token_altered(monkeypatch):
    from repro_torch.serving.batched import BatchedServeEngine
    gen, advance = BatchedServeEngine.gen, BatchedServeEngine.advance

    def bad_gen(self, slots, ks):
        before = [len(self.generated(int(b))) for b in slots]
        out = gen(self, slots, ks)
        for b, n0, new in zip(slots, before, out):
            if n0 <= 5 < n0 + len(new):
                new[5 - n0] = (new[5 - n0] + 1) % self.model.cfg.vocab_size
                self.tokens[int(b)][self.n_prompt[int(b)] + 5] = new[5 - n0]
        return out

    def bad_advance(self, slots, toks):
        toks = [(int(t) + 1) % self.model.cfg.vocab_size
                if len(self.generated(int(b))) == 4 else int(t) for b, t in zip(slots, toks)]
        return advance(self, slots, toks)

    monkeypatch.setattr(BatchedServeEngine, "gen", bad_gen)
    monkeypatch.setattr(BatchedServeEngine, "advance", bad_advance)


def _answer_altered(monkeypatch):
    from repro_torch.retrieval.retrievers import ExactDenseRetriever
    search = ExactDenseRetriever._search

    def bad(self, queries, k):
        ids, scores = search(self, queries, k)
        return (ids + 1) % self.kb.size, scores

    monkeypatch.setattr(ExactDenseRetriever, "_search", bad)


def _state_unchanged(monkeypatch):
    from repro_torch.models.model import Model
    step = Model.decode_step

    def bad(self, params, state, token, pos):
        logits, _ = step(self, params, state, token, pos)
        return logits, state

    monkeypatch.setattr(Model, "decode_step", bad)


def _half_batch(monkeypatch):
    from repro_torch.models.model import Model
    step = Model.decode_step

    def bad(self, params, state, token, pos):
        logits, new = step(self, params, state, token, pos)
        h = max(logits.shape[0] // 2, 1)
        logits = torch.cat([logits[:h], logits[:h].mean(0, keepdim=True)
                            .expand(logits.shape[0] - h, -1)])
        return logits, new

    monkeypatch.setattr(Model, "decode_step", bad)


def _decode_logits_off(monkeypatch):
    """A lower precision confined to the decode step: its logits off by
    1e-2, too little to move most greedy tokens."""
    from repro_torch.models.model import Model
    step = Model.decode_step

    def bad(self, params, state, token, pos):
        logits, new = step(self, params, state, token, pos)
        return logits + 1e-2 * torch.randn_like(logits), new

    monkeypatch.setattr(Model, "decode_step", bad)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_token_altered, _answer_altered, _state_unchanged,
                                   _half_batch, _decode_logits_off])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = run_tiny(cell)
    assert out["correct"] is False, out["checks"]
    assert any(c["value"] > c["limit"] or not np.isfinite(c["value"])
               for c in out["checks"].values()) or out["failed"]
