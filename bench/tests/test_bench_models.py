"""CPU tests of the model seam: a configuration names its model module by its
``"reference"`` key (``bench/reference/model.py``, the dense decoder, where
it names none), and every model-specific step of the harness goes through
that module. The dense path reads what it read before the seam; a
non-dense configuration and its cell come in by adding files alone.

    python -m pytest -q bench/tests
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench.tests.test_bench_harness import _digest
from bench.tests.tiny import ROOT, run_tiny, small, tiny
from bench import cells, data, yardstick
from bench.reference import model as dense
from bench.serve import port_config

torch.set_num_threads(2)

CELLS = ["knnlm-edr-c8", "ralm-edr-c8"]

# sha256 of make_params' leaves (sorted paths, each path's repr then its
# float32 bytes), computed before the seam: tiny size, seed 12345678901;
# the variant with qkv biases, an untied head and no q/k norms at seed 2^33 + 5
WEIGHTS_SHA = {"knnlm-edr-c8": "c614fe92927a3652040cc983ee28e9b2a067d0a6c9ae65ff6175892f353c94cb",
               "ralm-edr-c8": "c614fe92927a3652040cc983ee28e9b2a067d0a6c9ae65ff6175892f353c94cb"}
VARIANT_SHA = "7cb9d16f173a3d6bcd6448f3906635b10e73ec9c7a3160b5812b4fb4d0cd715f"
# the keys the port's ModelConfig was built from before the seam
PARENT_KEYS = ("family", "num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
               "d_ff", "vocab_size", "qkv_bias", "qk_norm", "rope_theta", "norm_eps",
               "tie_embeddings")


def _leaves(node, path=()):
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _leaves(node[k], path + (k,))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _leaves(v, path + (i,))
    else:
        yield path, node


def _sha(params) -> str:
    h = hashlib.sha256()
    for path, leaf in _leaves(params):
        h.update(repr(path).encode())
        h.update(leaf.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("cell", CELLS)
def test_the_dense_weights_are_the_same_bit_for_bit(cell):
    cfg, _ = tiny(cell)
    assert _sha(data.make_params(cfg, 12345678901, torch.device("cpu"))) == WEIGHTS_SHA[cell]
    assert cells.find(cell).model.param_layout(cfg) == data.param_layout(cfg)


def test_the_dense_layout_keeps_biases_and_an_untied_head():
    cfg, _ = tiny("ralm-edr-c8")
    cfg.update(qkv_bias=True, tie_embeddings=False, qk_norm=False)
    params = data.make_params(cfg, 2 ** 33 + 5, torch.device("cpu"))
    assert _sha(params) == VARIANT_SHA
    assert set(params) == {"embed", "final_norm", "unembed", "layers"}
    assert set(params["layers"][1]["mixer"]) == {"wq", "wk", "wv", "wo", "bq", "bk", "bv"}


@pytest.mark.parametrize("cell", CELLS)
def test_port_config_equals_the_one_built_before_the_seam(cell):
    from repro_torch.configs.base import ModelConfig
    for cfg in (cells.find(cell).config, tiny(cell)[0]):
        assert port_config(cfg) == ModelConfig(name=cfg["name"],
                                               **{k: cfg[k] for k in PARENT_KEYS})


def _as_file(port) -> dict:
    """A port ModelConfig written as a configuration file states it."""
    keys = set(PARENT_KEYS) | {"name", "moe", "ssm", "block_pattern", "moe_layer_rule",
                               "sliding_window"}
    out = {k: v for k, v in dataclasses.asdict(port).items() if k in keys and v is not None}
    return json.loads(json.dumps(out))          # tuples become lists, as in a file


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b", "jamba-v0.1-52b",
                                  "xlstm-350m"])
def test_port_config_takes_every_model_field_a_file_states(arch):
    from repro_torch.configs import get_config
    port = dataclasses.replace(get_config(arch), source="")
    assert port_config(_as_file(port)) == port


def test_a_hybrid_at_test_size_keeps_each_mixer_kind_and_an_moe_layer():
    from repro_torch.configs import get_config
    got = port_config(small(_as_file(get_config("jamba-v0.1-52b"))))
    assert got.layer_kinds() == ("mamba", "attn") and got.ssm.chunk == 32
    assert (got.moe.num_experts, got.moe.top_k, got.moe.d_expert) == (4, 2, 128)
    assert [got.layer_has_moe(i) for i in range(2)] == [False, True]


def _parent_forward(cfg, params, tokens, prec="fp32"):
    """``bench.reference.model.forward`` as it stood before the seam."""
    mm, rms_norm, rope = dense.mm, dense.rms_norm, dense.rope
    dev = params["embed"].device
    t = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
    S = t.shape[0]
    H, KV, hd, eps = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"], cfg["norm_eps"]
    pos = torch.arange(S, device=dev)
    x = params["embed"][t].float()
    with dense.precision(prec, dev):
        for lp in params["layers"]:
            a = lp["mixer"]
            h = rms_norm(x, lp["norm1"], eps)
            q, k, v = mm(h, a["wq"], prec), mm(h, a["wk"], prec), mm(h, a["wv"], prec)
            if cfg["qkv_bias"]:
                q, k, v = q + a["bq"], k + a["bk"], v + a["bv"]
            q, k = q.reshape(S, H, hd), k.reshape(S, KV, hd)
            if cfg["qk_norm"]:
                q, k = rms_norm(q, a["q_norm"], eps), rms_norm(k, a["k_norm"], eps)
            q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
            x = x + mm(dense.attention(q, k, v.reshape(S, KV, hd), prec), a["wo"], prec)
            f = lp["ffn"]
            h = rms_norm(x, lp["norm2"], eps)
            g = torch.nn.functional.silu(mm(h, f["w_gate"], prec)) * mm(h, f["w_up"], prec)
            x = x + mm(g, f["w_down"], prec)
        x = rms_norm(x, params["final_norm"], eps)
        head = params["embed"].T if cfg["tie_embeddings"] else params["unembed"]
        return mm(x, head, prec)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("prec", ["fp32", "tf32"])
def test_the_dense_reference_logits_are_unchanged(cell, prec):
    cfg, _ = tiny(cell)
    params = data.make_params(cfg, 77, torch.device("cpu"))
    toks = np.random.default_rng(5).integers(0, cfg["vocab_size"], 37).tolist()
    model = cells.find(cell).model
    want = _parent_forward(cfg, params, toks, prec)
    assert torch.equal(dense.forward(cfg, params, toks, prec), want)
    assert torch.equal(model.forward(cfg, params, toks, prec), want)


def test_the_dense_flops_are_the_yardsticks():
    cfg = cells.find("knnlm-edr-c8").config
    model = cells.find("knnlm-edr-c8").model
    assert model.token_flops(cfg, 300) == yardstick.token_flops(cfg, 300)
    assert yardstick.token_flops(cfg, 300) == \
        2.0 * sum(yardstick.dense_params(cfg)) + 4.0 * 28 * 16 * 128 * 300
    assert model.attention_layers(cfg) == list(range(28))


def test_a_family_other_than_dense_needs_a_reference_key():
    cfg = dict(tiny("knnlm-edr-c8")[0], family="moe",
               moe=dict(num_experts=4, top_k=2, d_expert=128))
    for call in (lambda: cells.model(cfg), lambda: data.param_layout(cfg),
                 lambda: data.make_params(cfg, 1, torch.device("cpu"))):
        with pytest.raises(ValueError, match='"reference"'):
            call()
    with pytest.raises(ValueError, match="not a module name"):
        cells.model(dict(cfg, reference="../../x"))


def test_b2_roofline_counts_the_attention_layers_only():
    from bench.harness import RunView
    reader = cells.load_module(ROOT / "bench/metrics/b2_roofline_pct.py", "b2_roofline_pct")
    cfg = dict(cells.find("knnlm-edr-c8").config, num_layers=8)
    trace = SimpleNamespace(device_time=lambda *names: 1e-3)
    rec = SimpleNamespace(decode_lens=[[5, 17, 300, 511]] * 6)

    def reading(layers):
        model = SimpleNamespace(attention_layers=lambda c: layers)
        return reader.read(RunView(cfg, None, rec, trace, 0, model=model))

    assert reading(list(range(8))) == pytest.approx(8 * reading([4]))
    assert reading(list(range(8))) == pytest.approx(8 * reading([0]))


def _moe_tree(tmp_path):
    """A copy of the benchmark with a tiny ``family: "moe"`` configuration,
    its model module and its cell added as files and entries."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "bench")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cfg = json.loads((tmp_path / "bench/configs/qwen3-0.6b-knnlm.json").read_text())
    cfg.update(name="moe-knnlm", family="moe", reference="moe_fixture",
               moe_layer_rule="dense_first",
               moe=dict(num_experts=4, top_k=2, d_expert=1408, num_shared_experts=1))
    (tmp_path / "bench/configs/moe-knnlm.json").write_text(json.dumps(cfg))
    shutil.copy(ROOT / "bench/tests/moe_fixture.py", tmp_path / "bench/reference/moe_fixture.py")
    (tmp_path / "bench/limits/moe-knnlm-c8.json").write_text(
        (tmp_path / "bench/limits/knnlm-edr-c8.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="moe-knnlm",
                                 file="bench/configs/moe-knnlm.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name="moe-knnlm-c8",
                                   config="moe-knnlm"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("tokens_per_s", "mfu_pct", "b2_roofline_pct"):
            m["workloads"].append("moe-knnlm-c8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert {k: v for k, v in _digest(tmp_path / "bench").items() if k in before} == before
    return tmp_path


@pytest.fixture(scope="module")
def moe_root(tmp_path_factory):
    return _moe_tree(tmp_path_factory.mktemp("moe"))


def test_a_moe_configuration_brings_its_own_model(moe_root):
    cell = cells.find("moe-knnlm-c8", moe_root)
    assert cell.model.__file__ == str(moe_root / "bench/reference/moe_fixture.py")
    cfg, port = tiny("moe-knnlm-c8", moe_root)
    assert cfg["moe"] == dict(num_experts=4, top_k=2, d_expert=128, num_shared_experts=1,
                              dispatch_chunk=64)
    assert port.moe.num_experts == 4 and port.moe_layer_rule == "dense_first"
    assert [port.layer_has_moe(i) for i in range(2)] == [False, True]
    params = data.make_params(cfg, 3, torch.device("cpu"), cell.model)
    assert "ffn" in params["layers"][0] and "moe" in params["layers"][1]
    assert params["layers"][1]["moe"]["w_gate"].shape == (4, 64, 128)
    assert params["layers"][1]["moe"]["shared"]["w_down"].shape == (128, 64)


def test_the_moe_fixture_equals_the_ports_serving_path(moe_root):
    from repro_torch.models.model import Model
    model = cells.find("moe-knnlm-c8", moe_root).model
    cfg, port = tiny("moe-knnlm-c8", moe_root)
    params = data.make_params(cfg, 11, torch.device("cpu"), model)
    toks = np.random.default_rng(2).integers(0, cfg["vocab_size"], 29).tolist()
    ours = model.forward(cfg, params, toks)
    with torch.no_grad():      # prefill runs the dropless MoE that serving runs
        for n in (1, 9, 29):
            last, _, _ = Model(port).prefill(params, torch.as_tensor([toks[:n]]))
            assert torch.allclose(ours[n - 1], last[0], atol=2e-5, rtol=0)


def test_the_moe_fixture_counts_the_experts_a_token_runs(moe_root):
    model = cells.find("moe-knnlm-c8", moe_root).model
    cfg, _ = tiny("moe-knnlm-c8", moe_root)
    d, f, ff = 64, 128, cfg["d_ff"]
    base = dense.token_flops(cfg, 40)
    routed = 2.0 * (d * 4 + (2 + 1) * 3 * d * f - 3 * d * ff)      # one MoE layer of two
    assert model.token_flops(cfg, 40) == base + routed
    assert model.token_flops(cfg, 40) != base + 2.0 * (d * 4 + (4 + 1) * 3 * d * f - 3 * d * ff)


@pytest.mark.parametrize("trace", [False, True])
def test_a_moe_cell_runs_correct_from_added_files(moe_root, trace, monkeypatch):
    from bench.trace import Trace
    if trace:     # a CPU trace has no B2 kernel: give it one, for the reader to find
        device_time = Trace.device_time
        monkeypatch.setattr(Trace, "device_time", lambda self, *names: 1.0
                            if "decode_attn_kernel" in names else device_time(self, *names))
    out = run_tiny("moe-knnlm-c8", trace=trace, root=moe_root)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 8, out
    if trace:
        assert {"mfu_pct", "b2_roofline_pct"} <= set(out["metrics"])
        assert all(out["metrics"][m]["value"] > 0 for m in ("mfu_pct", "b2_roofline_pct"))
    else:
        assert set(out["metrics"]) == {"tokens_per_s", "setup_s"}
