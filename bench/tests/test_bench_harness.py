"""CPU tests of the benchmark's harness: discovery by name, the result line,
the metric arithmetic, the traffic generator and the import check.

    python -m pytest -q bench/tests
"""
from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from bench.tests.tiny import ROOT, run_tiny
from bench import cells, yardstick
from bench.trace import Trace

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_follows_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["bench"] and b["command"] == ["python3", "bench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).exists()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    assert {m["name"] for m in b["end_to_end"]} == {"tokens_per_s", "device_ms_per_tok",
                                                    "setup_s"}
    cells_ = {w["name"] for w in b["workloads"]}
    for w in cells_:        # setup_s, another end-to-end metric and a per-layer one each
        e2e = {m["name"] for m in b["end_to_end"] if w in m.get("workloads", cells_)}
        assert "setup_s" in e2e and len(e2e) >= 2
        moved = {m["moves"] for m in b["per_layer"] if w in m.get("workloads", cells_)}
        assert moved and moved <= e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        mod = cells.load_module(ROOT / "bench" / "metrics" / f"{m['name']}.py", m["name"])
        assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == \
            (mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER, mod.MOVES)
        assert set(m["workloads"]) <= {w["name"] for w in b["workloads"]}


def _digest(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_config_mix_metric_and_cell_are_taken_in_by_adding_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "bench")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cfg = json.loads((tmp_path / "bench/configs/qwen3-0.6b-knnlm.json").read_text())
    cfg.update(name="knnlm-small", datastore_rows=1 << 20)
    (tmp_path / "bench/configs/knnlm-small.json").write_text(json.dumps(cfg))
    mix = json.loads((tmp_path / "bench/traffic/heldout-c8.json").read_text())
    mix.update(clients=4)
    (tmp_path / "bench/traffic/heldout-c4.json").write_text(json.dumps(mix))
    (tmp_path / "bench/metrics/requests_per_group.py").write_text(textwrap.dedent('''
        LAYER = "servers"
        UNIT = "req"
        BETTER = "higher"
        SOURCE = "program_counter"
        MOVES = "tokens_per_s"


        def read(run):
            return len(run.window.requests) / max(len(run.window.groups), 1)
    '''))
    (tmp_path / "bench/limits/knnlm-small-c4.json").write_text(
        (tmp_path / "bench/limits/knnlm-edr-c8.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="knnlm-small",
                                 file="bench/configs/knnlm-small.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name="knnlm-small-c4",
                                   config="knnlm-small", traffic="heldout-c4"))
    bench["per_layer"].append(dict(bench["per_layer"][0], name="requests_per_group",
                                   unit="req", better="higher", layer="servers",
                                   workloads=["knnlm-small-c4"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert {k: v for k, v in _digest(tmp_path / "bench").items() if k in before} == before
    cell = cells.find("knnlm-small-c4", tmp_path)
    assert cell.config["datastore_rows"] == 1 << 20 and cell.mix["clients"] == 4
    assert [m["name"] for m, _ in cell.per_layer] == ["requests_per_group"]
    assert cell.per_layer[0][1].UNIT == "req"
    first = next(cell.generator.groups(cell.mix, _FakeCorpus(), 3))
    assert len(first) == 4
    old = cells.find("knnlm-edr-c8", tmp_path)
    assert "requests_per_group" not in [m["name"] for m, _ in old.per_layer]


class _FakeCorpus:
    heldout = np.arange(100_000, dtype=np.int32) % 500
    passages = (np.arange(64 * 500, dtype=np.int32) % 500).reshape(500, 64)


@pytest.mark.parametrize("mix", ["heldout-c8", "qa-c8"])
def test_traffic_is_the_same_for_a_seed_and_keeps_its_lengths_across_seeds(mix):
    m = json.loads((ROOT / "bench/traffic" / f"{mix}.json").read_text())
    gen = cells.load_module(ROOT / "bench/traffic/closed_loop.py", "closed_loop")

    def first(seed, n):
        g = gen.groups(m, _FakeCorpus(), seed)
        return [next(g) for _ in range(n)]

    block = m["block"] // m["clients"]
    a, b, c = first(5, block), first(5, block), first(2 ** 33 + 7, block)
    assert a == b and a != c
    lens = lambda gs: sorted(len(p) for g in gs for p, _ in g)   # noqa: E731
    assert lens(a) == lens(c)
    assert min(lens(a)) == m["prompt"]["min_tokens"] and max(lens(a)) == m["prompt"]["max_tokens"]
    assert all(n == m["max_new"] and len(g) == m["clients"] for g in a for _, n in g)


def test_knnlm_prompts_are_held_out_from_the_datastore():
    import torch
    from bench import data
    from bench.reference.retrieval import encode, topk_scan
    from bench.tests.tiny import tiny
    cfg, _ = tiny("knnlm-edr-c8")
    corpus = data.Corpus(cfg, 4242, torch.device("cpu"))
    mix = json.loads((ROOT / "bench/traffic/heldout-c8.json").read_text())
    gen = cells.load_module(ROOT / "bench/traffic/closed_loop.py", "closed_loop")
    prompts = [p for p, _ in next(gen.groups(mix, corpus, 4242))]
    C, decay = cfg["encoder_window"], cfg["encoder_decay"]
    own = [corpus.stream[i:i + C].tolist() for i in (0, 777, 12345)]
    q = np.stack([encode(corpus.table, p, C, decay) for p in prompts + own])
    best = topk_scan(corpus.keys, q, 1, "cpu")["fp32"][0][:, 0]
    assert (best[len(prompts):] > 1 - 1e-5).all()      # the store's own text finds itself
    assert (best[:len(prompts)] < 1 - 1e-3).all()      # a held-out prompt does not


def test_yardstick_bounds():
    nbytes, flops = yardstick.dense_topk_work(8, 1 << 24, 1024, 8)
    assert nbytes == 4.0 * ((1 << 24) * 1024 + 8 * 1024 + 2 * 8 * 8)
    assert flops == 2.0 * 8 * (1 << 24) * 1024
    assert yardstick.bound_s(nbytes, flops) == pytest.approx(nbytes / 3.35e12)
    big = yardstick.dense_topk_work(128, 1 << 24, 1024, 8)
    assert yardstick.bound_s(*big) == pytest.approx(big[1] / 67e12)
    nb, fl = yardstick.decode_attention_work([1, 97, 600, 0], 512, 16, 16, 64)
    assert nb == 4.0 * (2 * 4 * 16 * 64 + (2 * (1 + 97 + 512) + 512) * 16 * 64 + 4)
    assert fl == 4.0 * 16 * 64 * (1 + 97 + 512 + 512)
    body, head = yardstick.dense_params(json.loads(
        (ROOT / "bench/configs/qwen3-0.6b-knnlm.json").read_text()))
    attn = 1024 * (16 + 2 * 8) * 128 + 16 * 128 * 1024 + 2 * 128
    assert (body, head) == (28 * (attn + 3 * 1024 * 3072 + 2048) + 1024, 1024 * 151936)
    assert round(body / 1e9, 2) == 0.44        # the model card's non-embedding count


def test_trace_reduction_idle_share_and_labels():
    ms = 1_000_000
    tr = Trace(window=(0, 100 * ms),
               device=[("void scan_kernel<float, 256>(float const*)", 10 * ms, 30 * ms),
                       ("decode_attn_kernel<64>", 25 * ms, 40 * ms),
                       ("Memcpy DtoH", 60 * ms, 70 * ms),
                       ("before", -5 * ms, 2 * ms)],
               spans=[("fleet.round", 1, 0, 100 * ms), ("engine.decode", 1, 40 * ms, 60 * ms),
                      ("kb.call", 2, 70 * ms, 95 * ms)])
    assert tr.busy_s == pytest.approx(0.042)
    assert tr.window_s == pytest.approx(0.1)
    assert tr.device_time("scan_kernel") == pytest.approx(0.02)
    assert [g for g in tr.gaps()] == [(2 * ms, 10 * ms), (40 * ms, 60 * ms), (70 * ms, 100 * ms)]
    idle = dict(tr.idle_by_label())
    assert idle == pytest.approx({"engine.decode": 0.02, "kb.call": 0.03, "fleet.round": 0.008})
    assert tr.top_ops()[0] == ["scan_kernel", pytest.approx(0.02)]


@pytest.mark.parametrize("cell", ["knnlm-edr-c8", "ralm-edr-c8"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_run_prints_the_contract_keys_and_is_correct(cell, trace):
    out = run_tiny(cell, trace=trace)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 8
    spec = cells.find(cell)
    if trace:
        want = {m["name"] for m, _ in spec.per_layer if m["name"].split(".")[0] not in
                ("b1_roofline_pct", "b2_roofline_pct", "device_idle_pct")}  # device trace only
        assert want <= set(out["metrics"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert out["device"]["window_s"] > 0
    else:                                      # the card's busy time: on a card only
        assert set(out["metrics"]) == {m["name"] for m in spec.end_to_end} - {"device_ms_per_tok"}
        assert all(v["value"] > 0 for v in out["metrics"].values())
    assert set(out["checks"]) == {"token_miss", "logit_err", "kb_err"}
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


def test_device_ms_per_tok_is_the_cards_busy_time_over_the_windows_tokens(monkeypatch, capsys):
    from bench import nvml, serve

    class Meter:                        # the card busy 40% of the window
        def __init__(self, index):
            pass

        def start(self):
            pass

        def stop(self):
            return 0.4

    windows = []
    run_window = serve.run_window
    monkeypatch.setattr(nvml, "BusyMeter", Meter)
    monkeypatch.setattr(serve, "run_window", lambda *a: windows.append(run_window(*a)) or
                        windows[-1])
    out = run_tiny("ralm-edr-c8", seconds=0.5)
    w = windows[0]
    assert out["metrics"]["device_ms_per_tok"] == {
        "value": pytest.approx(1000 * 0.4 * w.seconds / w.tokens), "unit": "ms"}
    assert "tokens_per_s" not in out["metrics"]


def test_the_busy_meter_reads_nothing_without_nvml(monkeypatch):
    from bench import nvml
    monkeypatch.setattr(nvml, "_handle", lambda index: None)
    m = nvml.BusyMeter(0)
    m.start()
    assert m.stop() is None


def test_the_run_loads_neither_jax_nor_the_jax_package():
    code = textwrap.dedent(f'''
        import sys
        sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / "src")!r}]
        from bench.tests.tiny import run_tiny
        from bench.harness import forbidden_modules
        out = run_tiny("knnlm-edr-c8", seconds=0.5)
        assert out["correct"], out
        names = {{m.split(".")[0] for m in sys.modules}}
        assert "repro_torch" in names
        print(sorted(names & {{"jax", "jaxlib", "flax", "repro"}}), forbidden_modules())
    ''')
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[] []"


def test_the_import_check_compares_whole_top_level_names(monkeypatch):
    from bench import harness
    monkeypatch.setitem(sys.modules, "repro_torch_like.sub", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert harness.forbidden_modules() == ["repro"]


def test_the_cli_refuses_a_machine_without_the_cards_it_needs():
    r = subprocess.run([sys.executable, str(ROOT / "bench/run.py"), "--workload",
                        "knnlm-edr-c8", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=ROOT,
                       env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and r.stdout.strip() == ""
