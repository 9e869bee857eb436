"""The port's sharded backends held against the reference's.

``sharded`` and ``int8-sharded`` (``repro_torch.retrieval.sharded``: one
controller, a scan per shard, one merge; on the CPU every shard's scan is
its kernel's plain version) must equal the reference's ``ShardedBackend``
and ``QuantizedShardedBackend`` (``shard_map`` over the 4 host devices that
conftest forces) byte for byte, ids and scores, for ``search`` and
``search_gathered``, on tie-heavy grid KBs (every dot product exact in fp32,
so only the canonical tie order tells results apart): N in {9, 100, 130,
257} (N = 9 over 4 shards leaves the last one empty; 130 and 257 leave it
short), S in {1, 2, 3, 4}, B in {1, 5, 12}, k in {1, 4, 20, 97, N} (k past
a shard's rows, past C, past N). The reference is called at B = 12; its
rows do not depend on the batch (checked below), so rows 0 and 0..4 stand
for its B = 1 and B = 5 calls. Then: one call per search, a port fleet over
``sharded`` with one merged call per round and RaLMSeq's tokens, and the
CLI with ``--mesh-shards 4``.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.retrieval.backends import QuantizedShardedBackend as RefQuantSharded
from repro.retrieval.backends import ShardedBackend as RefSharded
from repro_torch.configs import RaLMConfig
from repro_torch.kernels import dense_topk as DT
from repro_torch.kernels import gathered_topk as GT
from repro_torch.launch.serve import build_stack, make_server, variant_config
from repro_torch.retrieval import sharded as SH
from repro_torch.retrieval.backends import (QuantizedShardedBackend, ShardedBackend,
                                            TorchKernelBackend,
                                            TorchQuantizedKernelBackend, make_backend)
from repro_torch.training.data import make_queries

# six xdist workers share the host's cores: one torch thread each
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BACKEND_PAIRS = {"sharded": (RefSharded, ShardedBackend, TorchKernelBackend),
                 "int8-sharded": (RefQuantSharded, QuantizedShardedBackend,
                                  TorchQuantizedKernelBackend)}


def _grid(rng, n, d):
    return rng.integers(-2, 3, size=(n, d)).astype(np.float32) / 2


def _tie_heavy(rng, n, d):
    base = _grid(rng, max(n // 8, 2), d)
    return np.tile(base, (-(-n // base.shape[0]), 1))[:n]


def _cand(rng, B, C, N):
    """The IVF probe's form: id-sorted unique ids, -1 pads last, ragged; row
    2 all pad, row 1 a single id."""
    cand = np.full((B, C), -1, np.int64)
    for b in range(B):
        w = 0 if b == 2 else 1 if b == 1 else int(rng.integers(1, C + 1))
        cand[b, :w] = np.sort(rng.choice(N, size=w, replace=False))
    return cand


def _same(want, got, what):
    assert want[0].dtype == got[0].dtype == np.int64, what
    assert np.array_equal(want[0], got[0]), f"{what}: ids"
    assert np.array_equal(want[1], got[1]), f"{what}: scores"


@pytest.mark.parametrize("S", [1, 2, 3, 4])
@pytest.mark.parametrize("N", [9, 100, 130, 257])
@pytest.mark.parametrize("kind", ["sharded", "int8-sharded"])
def test_sharded_backends_equal_the_reference_bytes(kind, N, S):
    rng = np.random.default_rng(N * 10 + S)
    d = 12
    emb = _tie_heavy(rng, N, d)
    ref_cls, cls, _ = BACKEND_PAIRS[kind]
    ref, port = ref_cls(emb, n_shards=S), cls(emb, n_shards=S, device="cpu")
    assert ref.n_shards == port.n_shards == S and port.name == kind
    assert not port.exact if kind.startswith("int8") else port.exact
    qs = _grid(rng, 12, d)
    cand = _cand(rng, 12, 6 if N == 9 else 40, N)
    calls = 0
    for k in (1, 4, 20, 97, N):
        want = ref.search(qs, k)
        want_g = ref.search_gathered(qs, cand, k)
        assert want[0].shape == (12, min(k, N))
        assert want_g[0].shape == (12, min(k, cand.shape[1]))
        for B in (1, 5, 12):
            _same(tuple(w[:B] for w in want), port.search(qs[:B], k),
                  f"{kind} N={N} S={S} B={B} k={k} search")
            _same(tuple(w[:B] for w in want_g),
                  port.search_gathered(qs[:B], cand[:B], k),
                  f"{kind} N={N} S={S} B={B} k={k} search_gathered")
            calls += 2
    assert port.calls == calls


def test_reference_rows_do_not_depend_on_the_batch():
    """What lets the reference's B = 12 call stand for its B = 1 and B = 5
    calls above."""
    rng = np.random.default_rng(4)
    emb = _tie_heavy(rng, 130, 12)
    ref = RefSharded(emb, n_shards=3)
    qs, cand = _grid(rng, 12, 12), _cand(rng, 12, 40, 130)
    for B in (1, 5):
        _same(tuple(w[:B] for w in ref.search(qs, 20)), ref.search(qs[:B], 20), f"B={B}")
        _same(tuple(w[:B] for w in ref.search_gathered(qs, cand, 20)),
              ref.search_gathered(qs[:B], cand[:B], 20), f"gathered B={B}")


@pytest.mark.parametrize("kind", ["sharded", "int8-sharded"])
def test_sharded_equals_the_unsharded_kernel_backend(kind):
    """Through the kernels' plain versions here, and the kernels on the
    card (``tests/test_torch_gpu.py``): every shard count gives the
    unsharded backend's bytes, d padded at upload (d = 6)."""
    rng = np.random.default_rng(8)
    emb = _tie_heavy(rng, 301, 6)
    _, cls, flat_cls = BACKEND_PAIRS[kind]
    whole = flat_cls(emb, device="cpu")
    qs, cand = _grid(rng, 5, 6), _cand(rng, 5, 90, 301)
    for S in (2, 3, 7):
        port = cls(emb, n_shards=S, device="cpu")
        for k in (1, 20, 301):
            _same(whole.search(qs, k), port.search(qs, k), f"S={S} k={k}")
            _same(whole.search_gathered(qs, cand, k), port.search_gathered(qs, cand, k),
                  f"S={S} k={k} gathered")


def test_shards_split_launch_and_merge_as_documented(monkeypatch):
    """N = 9 over 4 shards: 3, 3, 3 and an empty shard that launches
    nothing; the scans see shard-local ids (candidates compacted to the
    front of each row, id-sorted, pads last) and the merge maps them back."""
    assert SH.shard_bounds(9, 4) == [(0, 3), (3, 6), (6, 9), (9, 9)]
    assert SH.shard_bounds(10, 3) == [(0, 4), (4, 8), (8, 10)]
    assert SH.shard_devices(3, "cpu") == [torch.device("cpu")] * 3
    emb = _grid(np.random.default_rng(1), 9, 4)
    port = ShardedBackend(emb, n_shards=4, device="cpu")
    assert [r.shape[0] for r in port._rows] == [3, 3, 3, 0]
    seen = []
    real = GT.fused_gathered_topk

    def spy(q, rows, cand, k):
        seen.append(cand.tolist())
        return real(q, rows, cand, k)
    monkeypatch.setattr(GT, "fused_gathered_topk", spy)
    before = DT.launches
    port.search(emb[:2], 9)
    port.search_gathered(emb[:2], np.asarray([[1, 4, 5, 8, -1], [0, 2, -1, -1, -1]]), 9)
    assert seen == [[[1, -1], [0, 2]], [[1, 2], [-1, -1]], [[2], [-1]]]
    # the CPU runs the plain versions: no launch is counted
    assert DT.launches == before
    ids, sc = port.search_gathered(emb[:1], np.asarray([[8, -1, -1]]), 3)
    assert ids.tolist() == [[8, -1, -1]] and sc[0, 1] == -np.inf


def test_make_backend_builds_the_sharded_pair():
    emb = _grid(np.random.default_rng(3), 40, 8)
    for name in ("sharded", "int8-sharded"):
        b = make_backend(name, emb, n_shards=3, device="cpu")
        assert b.name == name and b.n_shards == 3 and b.calls == 0
        assert b.kb_bytes == (emb.nbytes if name == "sharded" else 40 * 16 + 40 * 4)
    assert make_backend("sharded", emb, device="cpu").n_shards == 1   # one a CPU


@pytest.mark.parametrize("retriever", ["edr", "adr"])
def test_fleet_over_sharded_gives_ralmseq_tokens_one_call_per_round(retriever):
    """A reduced port stack over 4 shards: RaLMSeq's tokens equal those of
    the unsharded kernel backend's stack, and the 3-slot psa fleet's equal
    RaLMSeq's with one merged call per round plus its seed call."""
    rcfg = RaLMConfig(max_new_tokens=12)
    st = build_stack(retriever, n_docs=900, backend="sharded", mesh_shards=4,
                     device="cpu", rcfg=rcfg)
    one = build_stack(retriever, n_docs=900, backend="kernel", device="cpu", rcfg=rcfg)
    assert st.retriever.backend.n_shards == 4
    prompts = [(q * 12)[:40] for q in make_queries(st.docs, 3)]
    want = [make_server(one, scheduler="seq").serve(p).tokens for p in prompts]
    assert [make_server(st, scheduler="seq").serve(p).tokens for p in prompts] == want
    fleet_st = dataclasses.replace(st, engine=None, rcfg=variant_config("psa", st.rcfg))
    backend = st.retriever.backend
    with make_server(fleet_st, scheduler="fixed", n_slots=3) as fleet:
        c0 = backend.calls
        fr = fleet.serve(prompts)
    assert [r.tokens for r in fr.results] == want
    assert fr.kb_calls == fr.rounds + 1 == backend.calls - c0


def test_cli_serves_over_four_shards():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--retriever-backend", "sharded", "--mesh-shards", "4", "--mode", "both",
         "--concurrency", "2", "--requests", "2", "--max-new", "8", "--n-docs", "1000"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "sharded (4 shards on cpu)" in out.stdout, out.stdout
    assert "outputs identical: True" in out.stdout, out.stdout
