"""The plain reference decoder: a full causal forward pass in float32 over a
parameter dict in the port's layout, following the published equations of the
configurations it serves (Qwen3: RMSNorm, q and k each RMS-normalised per
head before RoPE with split halves, GQA softmax attention, SwiGLU FFN,
untied or tied head; optional qkv biases). No kernel, cache or batching. Imports nothing of the program.

It is the model of every configuration file without a ``"reference"`` key
(``bench.cells.model``), and provides what the harness asks of any model
module: ``param_layout``, ``forward``, ``token_flops`` and
``attention_layers``.

``prec`` is the arithmetic of every product: ``"fp32"`` (IEEE, TF32 off) or
``"tf32"`` (the control: TF32's 10-bit mantissa on each product's inputs,
the card's own TF32 mode there, the same rounding emulated on the CPU).
"""
from __future__ import annotations

import contextlib
import math

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (1 sign, 8 exponent, 10 mantissa bits), nearest
    even, kept in float32."""
    b = x.float().contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


@contextlib.contextmanager
def precision(prec: str, device):
    """TF32 on or off for the card's matrix products inside the block."""
    if prec not in ("fp32", "tf32"):
        raise ValueError(f"unknown precision {prec!r}")
    if torch.device(device).type != "cuda":
        yield
        return
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = prec == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _in(x: torch.Tensor, prec: str) -> torch.Tensor:
    """An operand of a product: rounded to TF32 where the control asks for
    it and the device has no TF32 mode of its own."""
    if prec == "tf32" and x.device.type != "cuda":
        return tf32_round(x)
    return x


def mm(a: torch.Tensor, b: torch.Tensor, prec: str = "fp32") -> torch.Tensor:
    return _in(a, prec) @ _in(b, prec)


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, positions, theta):
    """Split-half rotation of x (S, H, hd) at integer positions (S,)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, prec):
    """Causal softmax attention: q (S, H, hd), k/v (S, KV, hd) -> (S, H * hd)."""
    S, H, hd = q.shape
    KV = k.shape[1]
    k = k.repeat_interleave(H // KV, dim=1)
    v = v.repeat_interleave(H // KV, dim=1)
    s = mm(q.transpose(0, 1), k.permute(1, 2, 0), prec) / math.sqrt(hd)   # (H, S, S)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return mm(p, v.transpose(0, 1), prec).transpose(0, 1).reshape(S, H * hd)


def forward(cfg: dict, params: dict, tokens, prec: str = "fp32") -> torch.Tensor:
    """Logits (S, V) at every position of ``tokens`` (a list of ints)."""
    dev = params["embed"].device
    t = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
    S = t.shape[0]
    H, KV, hd, eps = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"], cfg["norm_eps"]
    pos = torch.arange(S, device=dev)
    x = params["embed"][t].float()
    with precision(prec, dev):
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
            x = x + mm(attention(q, k, v.reshape(S, KV, hd), prec), a["wo"], prec)
            f = lp["ffn"]
            h = rms_norm(x, lp["norm2"], eps)
            g = torch.nn.functional.silu(mm(h, f["w_gate"], prec)) * mm(h, f["w_up"], prec)
            x = x + mm(g, f["w_down"], prec)
        x = rms_norm(x, params["final_norm"], eps)
        head = params["embed"].T if cfg["tie_embeddings"] else params["unembed"]
        return mm(x, head, prec)


def param_layout(cfg: dict) -> list:
    """(path, shape, kind, scale) of every leaf of a dense decoder, in draw
    order, in the port's parameter layout: ``embed``, ``final_norm``,
    ``unembed`` and ``layers[i]`` {norm1, mixer {wq, wk, wv, wo[, bq, bk,
    bv][, q_norm, k_norm]}, norm2, ffn {w_gate, w_up, w_down}}. Matrices are
    (d_in, d_out)."""
    d, V = cfg["d_model"], cfg["vocab_size"]
    H, KV, hd, ff = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"], cfg["d_ff"]
    out = [(("embed",), (V, d), "w", d ** -0.5), (("final_norm",), (d,), "norm", 0.0)]
    if not cfg["tie_embeddings"]:
        out.append((("unembed",), (d, V), "w", d ** -0.5))
    for i in range(cfg["num_layers"]):
        p = ("layers", i)
        out += [(p + ("norm1",), (d,), "norm", 0.0),
                (p + ("mixer", "wq"), (d, H * hd), "w", 1 / math.sqrt(d)),
                (p + ("mixer", "wk"), (d, KV * hd), "w", 1 / math.sqrt(d)),
                (p + ("mixer", "wv"), (d, KV * hd), "w", 1 / math.sqrt(d)),
                (p + ("mixer", "wo"), (H * hd, d), "w", 1 / math.sqrt(H * hd))]
        if cfg["qkv_bias"]:
            out += [(p + ("mixer", "bq"), (H * hd,), "bias", 0.0),
                    (p + ("mixer", "bk"), (KV * hd,), "bias", 0.0),
                    (p + ("mixer", "bv"), (KV * hd,), "bias", 0.0)]
        if cfg["qk_norm"]:
            out += [(p + ("mixer", "q_norm"), (hd,), "norm", 0.0),
                    (p + ("mixer", "k_norm"), (hd,), "norm", 0.0)]
        out += [(p + ("norm2",), (d,), "norm", 0.0),
                (p + ("ffn", "w_gate"), (d, ff), "w", 1 / math.sqrt(d)),
                (p + ("ffn", "w_up"), (d, ff), "w", 1 / math.sqrt(d)),
                (p + ("ffn", "w_down"), (ff, d), "w", 1 / math.sqrt(ff))]
    return out


def dense_params(cfg: dict) -> tuple:
    """(non-embedding parameters, LM head parameters) of a dense decoder as
    the port builds it: per layer q/k/v/o (with biases where qkv_bias, and
    q and k norms where qk_norm), the SwiGLU FFN and two norms; the final
    norm; the head (the embedding itself where tied: its products count
    all the same)."""
    d, H, KV, hd = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    attn = d * (H + 2 * KV) * hd + H * hd * d
    if cfg.get("qkv_bias"):
        attn += (H + 2 * KV) * hd
    if cfg.get("qk_norm"):
        attn += 2 * hd
    per_layer = attn + 3 * d * cfg["d_ff"] + 2 * d
    return cfg["num_layers"] * per_layer + d, d * cfg["vocab_size"]


def attention_layers(cfg: dict) -> list:
    """The layers that attend over the ring cache (B2 in decode, B3 in
    prefill): every one."""
    return list(range(cfg["num_layers"]))


def token_flops(cfg: dict, context: int) -> float:
    """Model FLOPs of one token at a position with ``context`` tokens before
    and including it: 2 per weight (non-embedding and head), plus attention's
    q.k and p.v over the context in every attention layer."""
    body, head = dense_params(cfg)
    attn = 4.0 * len(attention_layers(cfg)) * cfg["num_heads"] * cfg["head_dim"] * context
    return 2.0 * (body + head) + attn
