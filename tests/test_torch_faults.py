"""The port's fault-injection harness against the reference's.

``parse_fault_spec`` must give the reference's results and raise its
one-line ``ValueError``s on the same strings; a ``FaultInjector`` must log
the reference's schedule for a seed (the same two uniforms per call from
``numpy.random.default_rng(seed)``). Served through the port's fleets with
faults injected into the KB path (EDR and ADR on the ``kernel`` backend, the
plain versions on the CPU; SR through ``FaultyKB``), every request must keep
the reference RaLMSeq's tokens, and the retry ledger (errors, timeouts,
failed calls, seed failures, degraded rounds, worker crashes) must equal the
reference fleet's on the same schedule. Parameters are converted from the
reference pytree; every comparison is exact.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import RaLMConfig as RefRaLMConfig
from repro.launch.serve import build_stack as ref_build_stack
from repro.launch.serve import make_server as ref_make_server
from repro.retrieval import faults as ref_faults
from repro.serving.continuous import as_requests as ref_as_requests
from repro_torch.configs import RaLMConfig
from repro_torch.launch.serve import build_stack, make_server
from repro_torch.models.convert import params_from_reference
from repro_torch.retrieval import faults
from repro_torch.serving.continuous import as_requests
from repro_torch.training.data import make_queries

# six xdist workers share the host's cores: one torch thread each
torch.set_num_threads(1)

N_DOCS = 1200
LEDGER = ("kb_errors", "kb_timeouts", "kb_failures", "seed_failures",
          "degraded_rounds", "worker_crashes", "rounds", "kb_calls")
CHAOS = "seed=7,p_error=0.4,p_spike=0.3,spike_s=0.002,max_faults=6"


# ---------------------------------------------------------------------------------
# the injector and its DSL
# ---------------------------------------------------------------------------------
@pytest.mark.parametrize("text", [
    "", "p_error=0.2,seed=3", CHAOS,
    "p_error=0.2, p_spike=0.1, spike_s=0.05, seed=9, error_calls=1;4;7, "
    "spike_calls=2, max_faults=5", "p-error=1,error_calls=;3;"])
def test_parse_fault_spec_equals_reference(text):
    ours, theirs = faults.parse_fault_spec(text), ref_faults.parse_fault_spec(text)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


@pytest.mark.parametrize("bad", ["p_error", "nope=1", "p_error=lots", "p_error=1.5",
                                 "p_spike=-0.1", "spike_s=-1", "error_calls=1;x",
                                 "seed=1.5"])
def test_parse_fault_spec_raises_as_the_reference(bad):
    with pytest.raises(ValueError) as ours:
        faults.parse_fault_spec(bad)
    with pytest.raises(ValueError) as theirs:
        ref_faults.parse_fault_spec(bad)
    assert str(ours.value) == str(theirs.value)
    assert "\n" not in str(ours.value)


def _fire(inj, n):
    for _ in range(n):
        try:
            inj.fire()
        except (faults.TransientRetrievalError, ref_faults.TransientRetrievalError):
            pass
    return inj


@pytest.mark.parametrize("text", ["seed=3,p_error=0.3,p_spike=0.3",
                                  "seed=11,p_error=0.3,p_spike=1.0",
                                  "error_calls=2;5,spike_calls=3",
                                  "p_error=1.0,max_faults=3", CHAOS])
def test_injector_log_equals_reference(text):
    ours = _fire(faults.FaultInjector(faults.parse_fault_spec(text)), 60)
    theirs = _fire(ref_faults.FaultInjector(ref_faults.parse_fault_spec(text)), 60)
    assert ours.log == theirs.log
    assert (ours.calls, ours.errors, ours.spikes) == (theirs.calls, theirs.errors,
                                                      theirs.spikes)


# ---------------------------------------------------------------------------------
# served through the fleets
# ---------------------------------------------------------------------------------
@pytest.fixture(scope="module", params=["edr", "adr", "sr"])
def pair(request):
    kw = dict(max_new_tokens=16, speculation_stride=3, retry_max=6)
    ref = ref_build_stack(request.param, n_docs=N_DOCS, rcfg=RefRaLMConfig(**kw))
    port = build_stack(request.param, n_docs=N_DOCS, device="cpu",
                       backend="numpy" if request.param == "sr" else "kernel",
                       rcfg=RaLMConfig(**kw))
    port.params = params_from_reference(port.cfg, jax.tree.map(np.asarray, ref.params))
    prompts = [(q * 12)[:48] for q in make_queries(port.docs, 3)]
    want = [ref_make_server(ref, scheduler="seq").serve(p).tokens for p in prompts]
    with ref_make_server(ref, scheduler="fixed", n_slots=3):
        pass                                   # ref.engine: one 3-slot engine
    return ref, port, prompts, want


def _faulty(stack, mod, spec_text, rebuild):
    """A copy of the stack whose retriever is a fresh one with the schedule
    injected (the stack's own stays clean); it shares the stack's engine, so
    the reference compiles its decode functions once."""
    st = dataclasses.replace(stack, retriever=rebuild(stack))
    return st, mod.inject_faults(st.retriever, mod.parse_fault_spec(spec_text))


def _fresh(stack):
    r = stack.retriever
    if stack.retriever_kind == "sr":
        return type(r)(r.kb)
    if stack.retriever_kind == "adr":              # the same index, no new k-means
        out = type(r).__new__(type(r))
        out.__dict__.update(r.__dict__)
        out.stats = type(r.stats)(r.stats.kind)
        return out
    return type(r)(r.kb, backend=r.backend)


@pytest.mark.parametrize("mode", ["fleet", "continuous"])
def test_fleet_under_transient_faults_matches_reference(pair, mode):
    """A provably transient schedule (at most 6 faults, 7 attempts per call):
    tokens are the reference RaLMSeq's, and the ledger is the reference
    fleet's under the same schedule."""
    ref, port, prompts, want = pair
    st, inj = _faulty(port, faults, CHAOS, _fresh)
    rst, rinj = _faulty(ref, ref_faults, CHAOS, _fresh)
    sched = dict(scheduler="continuous" if mode == "continuous" else "fixed", n_slots=3)
    with make_server(st, **sched) as srv:
        ours = srv.serve(as_requests(prompts) if mode == "continuous" else prompts)
    with ref_make_server(rst, **sched) as srv:
        theirs = srv.serve(ref_as_requests(prompts) if mode == "continuous" else prompts)
    assert inj.injected > 0 and ours.kb_errors > 0
    assert [r.tokens for r in ours.results] == want
    assert [r.status for r in ours.results] == ["ok"] * 3
    assert inj.log == rinj.log
    assert {c: getattr(ours, c) for c in LEDGER} == {c: getattr(theirs, c) for c in LEDGER}


def test_async_fleet_worker_crash_recovers(pair):
    """An error forced on the first merged verification call with no retry
    budget dies on the worker thread: the round re-runs synchronously and
    the tokens stay the reference RaLMSeq's. BM25 draws once per query, so
    there the first merged call's first draw follows the three seed queries."""
    ref, port, prompts, want = pair
    rcfg = dataclasses.replace(port.rcfg, retry_max=0, async_verification=True,
                               async_gate_ratio=0.0, async_min_overlap=16)
    first = len(prompts) if port.retriever_kind == "sr" else 1
    st, inj = _faulty(dataclasses.replace(port, rcfg=rcfg), faults,
                      f"error_calls={first}", _fresh)
    with make_server(st, scheduler="fixed", n_slots=3) as fleet:
        fr = fleet.serve(prompts)
    assert inj.errors == 1 and fr.worker_crashes == 1 and fr.kb_failures == 1
    assert fr.degraded_rounds == 0
    assert [r.tokens for r in fr.results] == want


def test_timeouts_and_degraded_rounds_match_reference(pair):
    """Spikes past the deadline are discarded and retried (tokens kept); a
    KB that fails every attempt degrades rounds to speculation-only, with
    the reference's ledger and the reference's degraded tokens."""
    ref, port, prompts, want = pair
    first = len(prompts) if port.retriever_kind == "sr" else 1   # the second attempt
    spike = dict(retrieval_timeout_s=0.5, retry_max=3)
    st, _ = _faulty(dataclasses.replace(port, rcfg=dataclasses.replace(port.rcfg, **spike)),
                    faults, f"spike_calls=0;{first},spike_s=1.0", _fresh)
    with make_server(st, scheduler="fixed", n_slots=3) as fleet:
        fr = fleet.serve(prompts)
    assert (fr.kb_timeouts, fr.kb_failures, fr.kb_errors) == (2, 0, 0)
    assert [r.tokens for r in fr.results] == want
    down = dict(retry_max=1)
    st, _ = _faulty(dataclasses.replace(port, rcfg=dataclasses.replace(port.rcfg, **down)),
                    faults, "p_error=1.0", _fresh)
    rst, _ = _faulty(dataclasses.replace(ref, rcfg=dataclasses.replace(ref.rcfg, **down)),
                     ref_faults, "p_error=1.0", _fresh)
    with make_server(st, scheduler="fixed", n_slots=3) as fleet:
        ours = fleet.serve(prompts)
    with ref_make_server(rst, scheduler="fixed", n_slots=3) as fleet:
        theirs = fleet.serve(prompts)
    assert ours.seed_failures == 1 and ours.degraded_rounds > 0
    assert [r.status for r in ours.results] == ["degraded"] * 3
    assert [r.tokens for r in ours.results] == [r.tokens for r in theirs.results]
    assert {c: getattr(ours, c) for c in LEDGER} == {c: getattr(theirs, c) for c in LEDGER}
