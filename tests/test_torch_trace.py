"""The port's tracer (``repro_torch.trace``) and the spans of its serving path.

Off, serving records nothing; under ``recording()`` the span tree of a
fixed fleet is the program's layering (``engine.dispatch`` in
``engine.decode`` in a ``fleet.*`` stage in a ``fleet.round``; the async
worker's ``fleet.verify`` a child of its round) and the span counts are the
program's own counters; the served tokens do not move. Under
``torch.profiler`` the tracer records by itself, on the profiler's clock.
Each fleet request carries its admission, first-token and finish times.
"""
import dataclasses
import threading

import pytest
import torch

from repro_torch import trace
from repro_torch.configs import RaLMConfig
from repro_torch.launch.serve import build_stack, make_server
from repro_torch.serving.continuous import as_requests

# six xdist workers share the host's cores: one torch thread each
torch.set_num_threads(1)

MAX_NEW, SLOTS = 12, 3
ASYNC = dict(async_verification=True, async_gate_ratio=0.0, async_min_overlap=2)


@pytest.fixture(autouse=True)
def _empty():
    trace.clear()
    yield
    trace.clear()


@pytest.fixture(scope="module")
def stacks():
    rcfg = RaLMConfig(max_new_tokens=MAX_NEW, speculation_stride=3)
    ralm = build_stack("edr", n_docs=400, backend="kernel", device="cpu", rcfg=rcfg)
    knn = build_stack("edr", n_docs=300, workload="knnlm", knn_entries=3000,
                      backend="kernel", device="cpu", rcfg=rcfg)
    prompts = {"ralm": [list(d[:24]) * 2 for d in ralm.docs[5:8]],
               "knnlm": [knn.stream[i * 97:i * 97 + 40].tolist() for i in range(SLOTS)]}
    return {"ralm": ralm, "knnlm": knn}, prompts


def _server(stacks, workload, mode, scheduler="fixed"):
    by, prompts = stacks
    st = by[workload]
    rcfg = st.rcfg if mode == "sync" else dataclasses.replace(st.rcfg, **ASYNC)
    st = dataclasses.replace(st, rcfg=rcfg, engine=None)
    return make_server(st, scheduler=scheduler, n_slots=SLOTS), prompts[workload]


def _serve(srv, prompts, scheduler="fixed"):
    eng, retr = srv.engine, srv.retriever
    c0 = retr.stats.calls
    fr = srv.serve(as_requests(prompts) if scheduler == "continuous" else prompts)
    return fr, retr.stats.calls - c0, eng.stats.prefills


# ---------------------------------------------------------------------------------
# the tracer itself
# ---------------------------------------------------------------------------------
def test_off_a_site_gets_the_shared_noop_and_nothing_is_kept():
    assert not trace.on()
    sp = trace.span("x", a=1)
    assert sp is trace.OFF and sp.id == 0
    with sp as s:
        s.set(b=2)
    trace.record("request", 1, 2, rid=0)
    assert trace.spans() == []


def test_spans_nest_per_thread_and_take_an_explicit_parent():
    with trace.recording():
        with trace.span("outer", n=1) as outer:
            with trace.span("inner") as inner:
                inner.set(k=3)

            def work():
                with trace.span("worker", parent=outer.id):
                    with trace.span("leaf"):
                        pass
            t = threading.Thread(target=work)
            t.start()
            t.join()
            trace.record("request", outer.t0, outer.t0 + 5, rid=7)
    by = {s.name: s for s in trace.spans()}
    assert set(by) == {"outer", "inner", "worker", "leaf", "request"}
    assert by["outer"].parent == 0 and by["outer"].attrs == {"n": 1}
    assert by["inner"].parent == by["outer"].id and by["inner"].attrs == {"k": 3}
    assert by["worker"].parent == by["outer"].id
    assert by["worker"].thread != by["outer"].thread
    assert by["leaf"].parent == by["worker"].id and by["leaf"].thread == by["worker"].thread
    assert by["request"].parent == by["outer"].id
    assert by["request"].t1_ns - by["request"].t0_ns == 5
    assert by["outer"].t0_ns <= by["inner"].t0_ns <= by["inner"].t1_ns <= by["outer"].t1_ns
    assert not trace.on()


def test_recording_nests_and_off_leaves_it_as_it_is():
    with trace.recording():
        with trace.recording(False):
            assert trace.on()
        with trace.recording():
            pass
        assert trace.on()
    with trace.recording(False):
        assert not trace.on()


def test_the_buffer_is_capped_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 3)
    with trace.recording():
        for _ in range(5):
            with trace.span("s"):
                pass
    assert len(trace.spans()) == 3 and trace.dropped() == 2
    trace.clear()
    assert trace.spans() == [] and trace.dropped() == 0


# ---------------------------------------------------------------------------------
# the serving path's spans
# ---------------------------------------------------------------------------------
def test_serving_with_tracing_off_records_nothing(stacks):
    srv, prompts = _server(stacks, "ralm", "async")
    with srv:
        fr, _, _ = _serve(srv, prompts)
    assert fr.total_tokens == SLOTS * MAX_NEW
    assert trace.spans() == []


def _ancestor_names(s, by_id):
    out = []
    while s.parent:
        s = by_id[s.parent]
        out.append(s.name)
    return out


@pytest.mark.parametrize("workload,mode", [("ralm", "sync"), ("ralm", "async"),
                                           ("knnlm", "async")])
def test_the_span_tree_and_counts_of_a_fleet(stacks, workload, mode):
    srv, prompts = _server(stacks, workload, mode)
    with srv:
        off, _, _ = _serve(srv, prompts)
        with trace.recording():
            fr, kb_calls, prefills = _serve(srv, prompts)
    assert [r.tokens for r in fr.results] == [r.tokens for r in off.results]
    sp = trace.spans()
    by_id = {s.id: s for s in sp}
    names = [s.name for s in sp]
    main = threading.get_native_id()

    assert names.count("fleet.round") == fr.rounds
    assert names.count("kb.call") == kb_calls == fr.kb_calls
    assert names.count("engine.prefill") == prefills
    assert names.count("request") == SLOTS
    assert names.count("fleet.seed") == 1
    dispatch = [s for s in sp if s.name == "engine.dispatch"]
    assert dispatch and all(s.attrs["live"] >= 1 for s in dispatch)
    for s in dispatch:
        up = _ancestor_names(s, by_id)
        assert up[0] == "engine.decode"
        assert up[1] in ("fleet.speculate", "fleet.overlap", "fleet.correct")
        assert up[2] == "fleet.round"
    for s in sp:
        if s.name in ("engine.readback", "engine.commit"):
            assert by_id[s.parent].name == "engine.decode"
        if s.name in ("engine.prefill.dispatch",):
            assert by_id[s.parent].name == "engine.prefill"
        if s.name == "kb.call":
            assert by_id[s.parent].name == "fleet.verify"
            assert s.attrs["B"] >= 1 and s.attrs["k"] >= 1
        if s.parent:                       # a child lies inside its parent
            p = by_id[s.parent]
            assert p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns, (s, p)
    verify = [s for s in sp if s.name == "fleet.verify"]
    worker = [s for s in verify if s.thread != main]
    if mode == "async":
        assert worker and names.count("fleet.join") == len(worker) == fr.rounds
        assert all(by_id[s.parent].name == "fleet.round" for s in worker)
    else:
        assert not worker and "fleet.join" not in names and "fleet.overlap" not in names
        assert sum(by_id[s.parent].name == "fleet.round" for s in verify) == fr.rounds
    commits = [s for s in sp if s.name == "fleet.commit"]
    assert len(commits) == fr.rounds
    assert sum(s.attrs["mismatches"] for s in commits) == \
        sum(r.mismatches for r in fr.results)
    assert names.count("fleet.correct") == sum(s.attrs["mismatches"] > 0 for s in commits)
    if workload == "knnlm":
        roles = {s.attrs["role"] for s in sp if s.name == "knn.interpolate"}
        assert roles == {"speculate", "verify"} and "knn.peek" in names
    reqs = sorted((s for s in sp if s.name == "request"), key=lambda s: s.attrs["rid"])
    assert [s.attrs["tokens"] for s in reqs] == [len(r.tokens) for r in fr.results]
    assert [(s.t0_ns, s.t1_ns, s.attrs["first_token_ns"]) for s in reqs] == \
        [(r.admitted_ns, r.finished_ns, r.first_token_ns) for r in fr.results]


@pytest.mark.parametrize("scheduler", ["fixed", "continuous"])
def test_each_request_carries_admission_first_token_and_finish(stacks, scheduler):
    srv, prompts = _server(stacks, "ralm", "async", scheduler)
    with srv:
        with trace.recording():
            fr, _, _ = _serve(srv, prompts, scheduler)
    prefill = [s for s in trace.spans() if s.name == "engine.prefill"]
    for r in fr.results:
        assert 0 < r.admitted_ns <= r.first_token_ns <= r.finished_ns
        first = min((s for s in prefill if s.t0_ns >= r.admitted_ns), key=lambda s: s.t0_ns)
        assert r.first_token_ns >= first.t1_ns
    trace.clear()
    srv, prompts = _server(stacks, "ralm", "sync", scheduler)
    with srv:
        off, _, _ = _serve(srv, prompts, scheduler)
    assert all(0 < r.admitted_ns <= r.first_token_ns <= r.finished_ns for r in off.results)
    assert trace.spans() == []


def test_under_the_profiler_the_tracer_records_on_its_clock(stacks):
    srv, prompts = _server(stacks, "ralm", "async")
    acts = [torch.profiler.ProfilerActivity.CPU]
    with srv:
        with torch.profiler.profile(activities=acts) as prof:
            fr, _, _ = _serve(srv, prompts)
    sp = [s for s in trace.spans() if s.name != "request"]
    assert len([s for s in sp if s.name == "fleet.round"]) == fr.rounds
    iv = sorted((s.t0_ns, s.t1_ns) for s in sp)
    lo, hi = iv[0][0], max(t1 for _, t1 in iv)
    aten = [(e.name(), e.start_ns()) for e in prof.profiler.kineto_results.events()
            if e.name().startswith("aten::") and lo <= e.start_ns() <= hi]
    assert len(aten) > 100

    def inside(t, spans):
        return any(a <= t <= b for a, b in spans)
    share = sum(inside(t, iv) for _, t in aten) / len(aten)
    assert share >= 0.95, share
    argmax = [t for n, t in aten if n == "aten::argmax"]
    readback = [(s.t0_ns, s.t1_ns) for s in sp if s.name == "engine.readback"]
    assert argmax and sum(inside(t, readback) for t in argmax) / len(argmax) >= 0.95
    assert any(s.name == "engine.dispatch" for s in sp) and not trace.on()
