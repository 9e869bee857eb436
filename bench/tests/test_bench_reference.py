"""CPU tests of the plain reference: its pieces against each other and
against brute force, its decoder against the port's at a tiny size, and its
sequential loops against tokens it generates itself.

    python -m pytest -q bench/tests
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bench.tests.tiny import tiny
from bench import data
from bench.reference import loops
from bench.reference.model import forward, tf32_round
from bench.reference.retrieval import encode, interpolate_logp, topk_scan

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=["knnlm-edr-c8", "ralm-edr-c8"])
def small(request):
    cfg, port = tiny(request.param)
    return cfg, port, data.Corpus(cfg, 99, torch.device("cpu"))


def test_the_reference_decoder_is_causal(small):
    cfg, _, corpus = small
    toks = list(np.random.default_rng(0).integers(0, cfg["vocab_size"], 40))
    full = forward(cfg, corpus.params, toks)
    for i in (0, 7, 39):
        assert torch.allclose(full[i], forward(cfg, corpus.params, toks[:i + 1])[-1],
                              atol=1e-5, rtol=0)


def test_the_reference_decoder_equals_the_ports_forward(small):
    from repro_torch.models.model import Model
    cfg, port, corpus = small
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg["vocab_size"], (1, 33)))
    ours = forward(cfg, corpus.params, toks[0].tolist())
    with torch.no_grad():
        theirs, _ = Model(port).forward(corpus.params, toks)
    assert torch.allclose(ours, theirs[0], atol=2e-5, rtol=0)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -12, -3.0, 1.0 + 3 * 2 ** -11])
    assert tf32_round(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0, -3.0, 1.0 + 2 ** -9]
    r = torch.randn(10_000)
    assert ((tf32_round(r) - r).abs() <= r.abs() * 2 ** -11).all()


def test_the_blocked_scan_is_exact_and_the_control_differs():
    rng = np.random.default_rng(3)
    keys = rng.standard_normal((5000, 48)).astype(np.float32)
    q = rng.standard_normal((7, 48)).astype(np.float32)
    out = topk_scan(keys, q, 9, "cpu", ("fp32", "tf32"), block_bytes=4 * 48 * 600)
    s = q.astype(np.float64) @ keys.T.astype(np.float64)
    want = -np.sort(-s, axis=1)[:, :9]
    sc, ids = out["fp32"]
    assert np.abs(sc - want).max() < 1e-4
    assert np.abs(np.take_along_axis(s, ids, 1) - want).max() < 1e-4
    assert np.abs(out["tf32"][0] - sc).max() > 1e-5


def test_the_interpolation_picks_the_ports_token():
    from repro_torch.core.knnlm import knn_interpolate
    rng = np.random.default_rng(4)
    for _ in range(50):
        lm = rng.standard_normal(300).astype(np.float32) * 2
        vals = rng.integers(0, 300, 8)
        sc = rng.uniform(0.5, 1.0, 8).astype(np.float32)
        assert int(np.argmax(interpolate_logp(lm, vals, sc, 0.25))) == \
            knn_interpolate(lm, vals, sc, 0.25)


def test_ties_at_the_boundary_give_every_set():
    s = np.array([0.9, 0.8, 0.7, 0.7 - 1e-7, 0.7 - 2e-7, 0.1])
    assert loops.tied(s, 3, 1e-5) == [(0, 1, 2), (0, 1, 3), (0, 1, 4)]
    assert loops.tied(s, 2, 1e-5) == [(0, 1)]
    assert loops.tied(s[:2], 4, 1e-5) == [(0, 1)]
    f32 = np.array([0.947, 0.9268, 0.9005, 0.8959, 0.8919, 0.8874, 0.88507247, 0.88506246,
                    0.8815], np.float32)     # float32 arithmetic would see neither sure nor tie
    assert loops.tied(f32, 8, 1e-5) == [tuple(range(8))]


def _ralm_generate(cfg, corpus, prompt, n):
    toks = []
    while len(toks) < n:
        q = encode(corpus.table, prompt + toks, cfg["encoder_window"], cfg["encoder_decay"])
        _, ids = topk_scan(corpus.keys, q[None], 1, "cpu")["fp32"]
        doc = loops.chunk(corpus.passages[int(ids[0, 0])], cfg["passage_tokens"])
        for _ in range(min(cfg["generation_stride"], n - len(toks))):
            toks.append(int(forward(cfg, corpus.params, doc + prompt + toks)[-1].argmax()))
    return toks


def _knnlm_generate(cfg, corpus, prompt, n):
    toks = []
    for _ in range(n):
        q = encode(corpus.table, prompt + toks, cfg["encoder_window"], cfg["encoder_decay"])
        sc, ids = topk_scan(corpus.keys, q[None], cfg["knn_k"], "cpu")["fp32"]
        lm = forward(cfg, corpus.params, prompt + toks)[-1].numpy()
        toks.append(int(np.argmax(interpolate_logp(lm, corpus.values[ids[0]], sc[0],
                                                   cfg["knn_lambda"]))))
    return toks


def test_the_sequential_loops_agree_with_the_reference_itself(small):
    cfg, _, corpus = small
    knn = cfg["workload"] == "knnlm"
    prompt = (corpus.stream[100:140] if knn else corpus.passages[5][:40]).tolist()
    gen = _knnlm_generate if knn else _ralm_generate
    req = {"prompt": prompt, "tokens": gen(cfg, corpus, prompt, 12)}
    make_q = loops.knnlm_queries if knn else loops.ralm_queries
    found = loops.scan(corpus.keys, make_q(req, cfg, corpus.table), cfg.get("knn_k", 1) + 4,
                       "cpu", "tf32")
    if knn:
        g = loops.judge_knnlm(cfg, forward, corpus.params, corpus.values, req, found, 1e-5, "tf32")
    else:
        g = loops.judge_ralm(cfg, forward, corpus.params, corpus.passages, req, found, 1e-5, "tf32")
    assert max(g["gaps"]) == 0.0 and len(g["gaps"]) == 12
    bad = dict(req, tokens=[(t + 1) % cfg["vocab_size"] for t in req["tokens"]])
    if knn:
        g = loops.judge_knnlm(cfg, forward, corpus.params, corpus.values, bad, found, 1e-5)
    else:
        g = loops.judge_ralm(cfg, forward, corpus.params, corpus.passages, bad, found, 1e-5)
    assert min(g["gaps"]) > 1e-3
