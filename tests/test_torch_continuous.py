"""Continuous batching of the port against the reference.

``make_arrivals`` and ``percentile`` must equal the reference's. The port's
ContinuousFleetServer (two slots, five requests with their own budgets, so
requests queue, are admitted mid-flight and reuse slots) must give the
reference RaLMSeq's tokens for EDR and ADR (``kernel`` backend, the plain
versions on the CPU) and SR, with one KB call per round plus the batched
seed calls — and, where the schedule does not depend on wall time (no
OS^3, synchronous rounds, arrivals at 0), the reference
ContinuousFleetServer's own counters: rounds, seed calls, KB calls and
queries, peak live slots, merged rows, shed requests. Parameters are
converted from the reference pytree; every comparison is exact.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import RaLMConfig as RefRaLMConfig
from repro.launch.serve import build_stack as ref_build_stack
from repro.launch.serve import make_arrivals as ref_make_arrivals
from repro.launch.serve import make_server as ref_make_server
from repro.serving.continuous import as_requests as ref_as_requests
from repro.serving.continuous import percentile as ref_percentile
from repro_torch.configs import RaLMConfig
from repro_torch.launch.serve import build_stack, make_arrivals, make_server
from repro_torch.models.convert import params_from_reference
from repro_torch.serving.continuous import (ContinuousFleetServer, Request,
                                            as_requests, percentile)
from repro_torch.training.data import make_queries

# six xdist workers share the host's cores: one torch thread each
torch.set_num_threads(1)

N_DOCS = 1200
BUDGETS = [16, 6, 11, 16, 4]
COUNTERS = ("rounds", "seed_calls", "kb_calls", "kb_queries", "max_live",
            "merged_rows", "merged_rows_saved", "shed", "kb_errors",
            "kb_failures", "degraded_rounds", "worker_crashes")


# ---------------------------------------------------------------------------------
# arrivals and percentiles
# ---------------------------------------------------------------------------------
@pytest.mark.parametrize("n,rate,trace,seed", [
    (8, 0.0, "", 0), (8, 2.0, "", 0), (12, 50.0, "", 3), (5, 2.0, "0,0.5,1.25", 0),
    (7, 0.0, " 0.1 ,0.2,,3", 1)])
def test_make_arrivals_equals_reference(n, rate, trace, seed):
    assert make_arrivals(n, rate, trace, seed) == ref_make_arrivals(n, rate, trace, seed)


def test_make_arrivals_trace_file_and_errors_equal_reference(tmp_path):
    f = tmp_path / "trace.txt"
    f.write_text("0.0\n0.5  # a comment\n\n1.25\n")
    assert make_arrivals(5, 0.0, f"@{f}") == ref_make_arrivals(5, 0.0, f"@{f}") \
        == [0.0, 0.5, 1.25, 0.0, 0.5]
    for bad in (" , ,", "0,-1", "0,zap,2", f"@{tmp_path / 'missing.txt'}"):
        with pytest.raises(ValueError) as ours:
            make_arrivals(3, 0.0, bad)
        with pytest.raises(ValueError) as theirs:
            ref_make_arrivals(3, 0.0, bad)
        assert str(ours.value) == str(theirs.value)


def test_percentile_and_requests_equal_reference():
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 7, 100):
        xs = rng.exponential(1.0, n).tolist()
        for q in (0, 25, 50, 90, 99, 100):
            assert percentile(xs, q) == ref_percentile(xs, q)
    prompts = [[1, 2], [3], [4, 5, 6]]
    ours = as_requests(prompts, arrivals=[0, 0.5, 1], max_new=[4, 5, 6])
    theirs = ref_as_requests(prompts, arrivals=[0, 0.5, 1], max_new=[4, 5, 6])
    assert [dataclasses.asdict(r) for r in ours] == [dataclasses.asdict(r) for r in theirs]


# ---------------------------------------------------------------------------------
# the server against the reference
# ---------------------------------------------------------------------------------
def _pair(retriever, rcfg=None):
    kw = dict(max_new_tokens=16, speculation_stride=3, **(rcfg or {}))
    ref = ref_build_stack(retriever, n_docs=N_DOCS, rcfg=RefRaLMConfig(**kw))
    port = build_stack(retriever, n_docs=N_DOCS, device="cpu",
                       backend="numpy" if retriever == "sr" else "kernel",
                       rcfg=RaLMConfig(**kw))
    port.params = params_from_reference(port.cfg, jax.tree.map(np.asarray, ref.params))
    prompts = [(q * 12)[:48] for q in make_queries(port.docs, len(BUDGETS))]
    return ref, port, prompts


@pytest.fixture(scope="module", params=["edr", "adr", "sr"])
def pair(request):
    ref, port, prompts = _pair(request.param)
    seq = ref_make_server(ref, scheduler="seq")
    want = [seq.serve(p).tokens for p in prompts]
    return ref, port, prompts, want


def _ref_seq_tokens(ref, prompts, budgets):
    """The reference RaLMSeq's tokens under per-request budgets, all on the
    engine the fixture's RaLMSeq compiled (``ref.engine``)."""
    out = []
    for p, mn in zip(prompts, budgets):
        st = dataclasses.replace(ref, rcfg=dataclasses.replace(
            ref.rcfg, max_new_tokens=mn))
        out.append(ref_make_server(st, scheduler="seq").serve(p).tokens)
    return out


def test_port_continuous_matches_reference_tokens_and_counters(pair):
    ref, port, prompts, _ = pair
    want = _ref_seq_tokens(ref, prompts, BUDGETS)
    with ref_make_server(dataclasses.replace(ref), scheduler="continuous",
                         n_slots=2) as srv:
        theirs = srv.serve(ref_as_requests(prompts, max_new=BUDGETS))
    with make_server(port, scheduler="continuous", n_slots=2) as srv:
        assert isinstance(srv, ContinuousFleetServer)
        ours = srv.serve(as_requests(prompts, max_new=BUDGETS))
    assert [r.tokens for r in ours.results] == [r.tokens for r in theirs.results] == want
    assert ours.kb_calls == ours.rounds + ours.seed_calls
    assert ours.seed_calls == 1, "later admissions should be pre-seeded"
    assert {c: getattr(ours, c) for c in COUNTERS} == \
        {c: getattr(theirs, c) for c in COUNTERS}
    assert [r.status for r in ours.results] == ["ok"] * len(prompts)
    assert [(r.rounds, r.mismatches, r.spec_steps) for r in ours.results] == \
        [(r.rounds, r.mismatches, r.spec_steps) for r in theirs.results]


def test_port_continuous_async_and_timed_arrivals_keep_tokens(pair):
    """Async (pipelined) rounds with the gate forced open, and arrivals
    spread over the modeled clock in shuffled submission order: the
    reference RaLMSeq's tokens per request."""
    ref, port, prompts, want = pair
    rcfg = dataclasses.replace(port.rcfg, async_verification=True,
                               async_gate_ratio=0.0, async_min_overlap=4)
    st = dataclasses.replace(port, rcfg=rcfg, engine=None)
    with make_server(st, scheduler="continuous", n_slots=2) as srv:
        cr = srv.serve(as_requests(prompts))
        assert [r.tokens for r in cr.results] == want
        assert cr.kb_calls == cr.rounds + cr.seed_calls
        reqs = [Request(rid=i, prompt=p, arrival=a) for i, (p, a) in
                enumerate(zip(prompts, make_arrivals(len(prompts), 40.0, seed=0)))]
        cr = srv.serve(reqs[::-1])
    assert [r.tokens for r in cr.results] == want
    assert cr.kb_calls == cr.rounds + cr.seed_calls
    assert len(cr.latencies) == len(prompts) and cr.p99 >= cr.p50 > 0


def test_port_continuous_sheds_as_the_reference_does():
    """Six arrivals at 0 on two slots with a depth-1 queue: the same requests
    are shed as in the reference, and the served ones keep their tokens."""
    ref, port, prompts = _pair("edr", dict(max_queue_depth=1))
    six = [prompts[i % 3] for i in range(6)]
    with ref_make_server(ref, scheduler="continuous", n_slots=2) as srv:
        theirs = srv.serve(ref_as_requests(six))
    with make_server(port, scheduler="continuous", n_slots=2) as srv:
        ours = srv.serve(as_requests(six))
    assert ours.shed == theirs.shed >= 3
    assert [r.status for r in ours.results] == [r.status for r in theirs.results]
    assert [r.tokens for r in ours.results] == [r.tokens for r in theirs.results]
    assert len(ours.latencies) == len([r for r in ours.results if r.ok])
    assert {c: getattr(ours, c) for c in COUNTERS} == \
        {c: getattr(theirs, c) for c in COUNTERS}
