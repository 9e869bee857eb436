"""The port's serving engines held against the reference engines on converted
parameters (reduced ralm-gpt2-medium, 2 layers, d_model 256).

Greedy tokens must be identical: to the reference ``ServeEngine`` /
``BatchedServeEngine`` on the same doc schedule, and between the port's
single and batched engines. Snapshots must survive further decode past the
ring wrap, and a row restore a round later must leave sibling slots alone —
the port's state updates build new tensors, so no snapshot is aliased.
"""
import jax
import numpy as np
import pytest

from repro.configs import get_config, reduced
from repro.models.model import Model as RefModel
from repro.serving.batched import BatchedServeEngine as RefBatched
from repro.serving.engine import ServeEngine as RefEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.models.convert import params_from_reference
from repro_torch.models.model import Model
from repro_torch.serving.batched import BatchedServeEngine
from repro_torch.serving.engine import ServeEngine

W = 80      # prompt 40 + doc 30 = 70: every run below wraps the ring


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_config("ralm-gpt2-medium"), layers=2, d_model=256)
    ref = RefModel(cfg)
    tree = ref.init(jax.random.PRNGKey(0))
    tcfg = t_reduced(t_get_config("ralm-gpt2-medium"), layers=2, d_model=256)
    params = params_from_reference(tcfg, jax.tree.map(np.asarray, tree))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, 512, 40).tolist() for _ in range(3)]
    docs = [tuple(rng.integers(2, 512, 30).tolist()) for _ in range(3)]
    return ref, tree, Model(tcfg), params, prompts, docs


def _schedule_single(eng, prompt, docs, b):
    eng.start(prompt, docs[b])
    eng.gen(5)
    eng.set_doc(docs[(b + 1) % 3])
    eng.gen(5)
    eng.set_doc(docs[(b + 2) % 3])
    eng.gen(8)
    return list(eng.generated)


def test_engines_match_reference_token_for_token(setup):
    ref, tree, model, params, prompts, docs = setup
    r_eng = RefEngine(ref, tree, cache_window=W)
    t_eng = ServeEngine(model, params, cache_window=W)
    want = [_schedule_single(r_eng, p, docs, b) for b, p in enumerate(prompts)]
    got = [_schedule_single(t_eng, p, docs, b) for b, p in enumerate(prompts)]
    assert got == want
    beng = BatchedServeEngine(model, params, 3, cache_window=W)
    for b, p in enumerate(prompts):
        beng.start(b, p, docs[b])
    beng.gen([0, 1, 2], [5, 5, 5])
    for b in range(3):
        beng.set_doc(b, docs[(b + 1) % 3])
    beng.gen([0, 1, 2], [5, 5, 5])
    for b in range(3):
        beng.set_doc(b, docs[(b + 2) % 3])
    beng.gen([0, 1, 2], [8, 8, 8])
    assert [beng.generated(b) for b in range(3)] == want


def test_peek_logits_and_advance_match_reference(setup):
    """An externally chosen token (what KNN-LM interpolation feeds back)
    decodes like a greedy one, and the next-token logits agree at 1e-4."""
    ref, tree, model, params, prompts, docs = setup
    r_eng = RefEngine(ref, tree, cache_window=W)
    t_eng = ServeEngine(model, params, cache_window=W)
    for eng in (r_eng, t_eng):
        eng.start(prompts[1], docs[1])
    for tok in (5, 77, 300) * 5:               # 15 steps: past W = 80
        r_eng.advance(tok)
        t_eng.advance(tok)
        np.testing.assert_allclose(r_eng.peek_logits(), t_eng.peek_logits(),
                                   rtol=1e-4, atol=1e-4)
    assert t_eng.generated == r_eng.generated == [5, 77, 300] * 5
    assert t_eng.gen(6) == r_eng.gen(6)


def test_snapshot_restore_after_decode_past_ring_wrap(setup):
    _, _, model, params, prompts, docs = setup
    eng = ServeEngine(model, params, cache_window=W)
    eng.start(prompts[0], docs[0])
    eng.gen(3)
    snap = eng.snapshot()
    first = eng.gen(20)                    # 73 -> 93 tokens: past W = 80
    eng.restore(snap)
    assert eng.gen(20) == first
    eng.restore(snap)
    eng.set_doc(docs[1])                   # re-prefill, then rewind again
    eng.gen(4)
    eng.restore(snap)
    assert eng.gen(20) == first


def test_batched_row_restore_a_round_later(setup):
    _, _, model, params, prompts, docs = setup
    ctrl = BatchedServeEngine(model, params, 3, cache_window=W)
    for b, p in enumerate(prompts):
        ctrl.start(b, p, docs[b])
    for _ in range(3):
        ctrl.gen([0, 1, 2], [8, 8, 8])
    eng = BatchedServeEngine(model, params, 3, cache_window=W)
    for b, p in enumerate(prompts):
        eng.start(b, p, docs[b])
    snap = eng.snapshot(1)
    eng.gen([0, 1, 2], [8, 8, 8])
    eng.set_doc(1, docs[2])                # slot 1 wanders off ...
    eng.gen([0, 1, 2], [8, 8, 8])
    eng.restore(1, snap)                   # ... and is rewound a round later
    eng.gen([0, 2], [8, 8])
    assert eng.generated(0) == ctrl.generated(0)
    assert eng.generated(2) == ctrl.generated(2)
    assert eng.generated(1) == []
    eng.gen([1], [24])                     # replays past the ring wrap
    assert eng.generated(1) == ctrl.generated(1)


def test_eos_and_budget_exits_match_reference(setup):
    ref, tree, model, params, prompts, docs = setup
    probe = BatchedServeEngine(model, params, 3, cache_window=W)
    for b, p in enumerate(prompts):
        probe.start(b, p, docs[b])
    eos = probe.gen([0], [3])[0][2]        # slot 0's third token
    r_eng = RefBatched(ref, tree, 3, cache_window=W, eos_id=eos)
    t_eng = BatchedServeEngine(model, params, 3, cache_window=W, eos_id=eos)
    for eng in (r_eng, t_eng):
        for b, p in enumerate(prompts):
            eng.start(b, p, docs[b])
    want = r_eng.gen([0, 1, 2], [10, 4, 12])
    got = t_eng.gen([0, 1, 2], [10, 4, 12])
    assert got == want
    assert got[0][-1] == eos and len(got[0]) == 3 and t_eng.finished(0)
    assert len(got[1]) == 4 or got[1][-1] == eos
    assert [t_eng.finished(b) for b in range(3)] == \
        [r_eng.finished(b) for b in range(3)]
    # after the exits every slot resumes from its OWN committed state
    assert t_eng.gen([1, 2], [3, 3]) == r_eng.gen([1, 2], [3, 3])
