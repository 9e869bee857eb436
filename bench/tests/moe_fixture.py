"""A plain reference model of the port's ``moe`` family, which the tests copy
to ``bench/reference/moe_fixture.py`` of a copied tree to show that a
configuration brings its own model by adding files alone.

The dense decoder (``model.py`` beside it in ``bench/reference/``, loaded by
path) with the FFN of each MoE layer replaced by routed experts as the
port's ``models/moe.py:apply_moe_exact`` defines them: a softmax over the
experts, the top k by a stable sort (the lower expert first among equals),
their weights renormalised to 1, and the shared experts' SwiGLU added to
every token. Imports nothing of the program.
"""
from __future__ import annotations

import math
from pathlib import Path

import torch

from bench.cells import load_module

DENSE = load_module(Path(__file__).with_name("model.py"), "bench_reference_moe_fixture_dense")


def has_moe(cfg: dict, layer: int) -> bool:
    """Whether MoE replaces the FFN of ``layer`` (the port's
    ``ModelConfig.layer_has_moe``)."""
    rule = cfg.get("moe_layer_rule", "all")
    return {"all": True, "every_2": layer % 2 == 1, "dense_first": layer >= 1}.get(rule, False)


def param_layout(cfg: dict) -> list:
    """The dense decoder's leaves, each MoE layer's ``ffn`` replaced by
    ``moe`` {router (d, E), w_gate / w_up (E, d, f), w_down (E, f, d)[,
    shared {w_gate, w_up (d, f s), w_down (f s, d)}]}."""
    d, m = cfg["d_model"], cfg["moe"]
    E, f, fs = m["num_experts"], m["d_expert"], m["d_expert"] * m.get("num_shared_experts", 0)
    out = []
    for path, shape, kind, scale in DENSE.param_layout(cfg):
        if path[0] == "layers" and path[2] == "ffn" and has_moe(cfg, path[1]):
            if path[3] == "w_gate":
                p = path[:2] + ("moe",)
                out += [(p + ("router",), (d, E), "w", 1 / math.sqrt(d)),
                        (p + ("w_gate",), (E, d, f), "w", 1 / math.sqrt(d)),
                        (p + ("w_up",), (E, d, f), "w", 1 / math.sqrt(d)),
                        (p + ("w_down",), (E, f, d), "w", 1 / math.sqrt(f))]
                if fs:
                    out += [(p + ("shared", "w_gate"), (d, fs), "w", 1 / math.sqrt(d)),
                            (p + ("shared", "w_up"), (d, fs), "w", 1 / math.sqrt(d)),
                            (p + ("shared", "w_down"), (fs, d), "w", 1 / math.sqrt(fs))]
            continue
        out.append((path, shape, kind, scale))
    return out


def _swiglu(h, w_gate, w_up, w_down, prec):
    g = torch.nn.functional.silu(DENSE.mm(h, w_gate, prec)) * DENSE.mm(h, w_up, prec)
    return DENSE.mm(g, w_down, prec)


def _moe(p: dict, m: dict, h: torch.Tensor, prec: str) -> torch.Tensor:
    probs = torch.softmax(DENSE.mm(h, p["router"], prec), dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :m["top_k"]], idx[:, :m["top_k"]]
    w = w / w.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(m["num_experts"]):
        share = (w * (idx == e)).sum(-1, keepdim=True)
        out = out + share * _swiglu(h, p["w_gate"][e], p["w_up"][e], p["w_down"][e], prec)
    if "shared" in p:
        s = p["shared"]
        out = out + _swiglu(h, s["w_gate"], s["w_up"], s["w_down"], prec)
    return out


def forward(cfg: dict, params: dict, tokens, prec: str = "fp32") -> torch.Tensor:
    """Logits (S, V) at every position of ``tokens`` (a list of ints)."""
    dev = params["embed"].device
    t = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
    S = t.shape[0]
    H, KV, hd, eps = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"], cfg["norm_eps"]
    pos = torch.arange(S, device=dev)
    x = params["embed"][t].float()
    with DENSE.precision(prec, dev):
        for lp in params["layers"]:
            a = lp["mixer"]
            h = DENSE.rms_norm(x, lp["norm1"], eps)
            q, k, v = (DENSE.mm(h, a[w], prec) for w in ("wq", "wk", "wv"))
            if cfg["qkv_bias"]:
                q, k, v = q + a["bq"], k + a["bk"], v + a["bv"]
            q, k = q.reshape(S, H, hd), k.reshape(S, KV, hd)
            if cfg["qk_norm"]:
                q, k = DENSE.rms_norm(q, a["q_norm"], eps), DENSE.rms_norm(k, a["k_norm"], eps)
            q, k = DENSE.rope(q, pos, cfg["rope_theta"]), DENSE.rope(k, pos, cfg["rope_theta"])
            x = x + DENSE.mm(DENSE.attention(q, k, v.reshape(S, KV, hd), prec), a["wo"], prec)
            h = DENSE.rms_norm(x, lp["norm2"], eps)
            if "moe" in lp:
                x = x + _moe(lp["moe"], cfg["moe"], h, prec)
            else:
                f = lp["ffn"]
                x = x + _swiglu(h, f["w_gate"], f["w_up"], f["w_down"], prec)
        x = DENSE.rms_norm(x, params["final_norm"], eps)
        head = params["embed"].T if cfg["tie_embeddings"] else params["unembed"]
        return DENSE.mm(x, head, prec)


def attention_layers(cfg: dict) -> list:
    """Every layer attends over the ring cache."""
    return list(range(cfg["num_layers"]))


def token_flops(cfg: dict, context: int) -> float:
    """The dense decoder's count with each MoE layer's FFN replaced by the
    experts a token runs: the router, its ``top_k`` routed experts and the
    shared ones, never all of them."""
    d, m = cfg["d_model"], cfg["moe"]
    body, head = DENSE.dense_params(cfg)
    active = m["top_k"] + m.get("num_shared_experts", 0)
    per_moe = d * m["num_experts"] + active * 3 * d * m["d_expert"] - 3 * d * cfg["d_ff"]
    body += sum(has_moe(cfg, i) for i in range(cfg["num_layers"])) * per_moe
    attn = 4.0 * len(attention_layers(cfg)) * cfg["num_heads"] * cfg["head_dim"] * context
    return 2.0 * (body + head) + attn
