"""Model assembly for the dense decoder family (the reference's
``repro.models.model.Model``, dense subset): ``init``, ``init_decode_state``,
``prefill`` and ``decode_step`` with its ring-buffer KV cache.

Parameters are a plain dict: ``embed`` (V, d), ``final_norm`` (d,),
``unembed`` (d, V) unless embeddings are tied, and ``layers``, one dict per
layer (``norm1``, ``mixer`` {wq, wk, wv, wo[, bq, bk, bv][, q_norm, k_norm]},
``norm2``, ``ffn`` {w_gate, w_up, w_down}). The reference stacks its layers
for ``lax.scan``; ``repro_torch.models.convert`` unstacks them.

The decode state is a list with one ``{"k", "v"}`` dict per layer, each
(B, W, KV, hd). Every method returns new tensors and never writes into the
state it was given, so a state held by an engine snapshot stays valid.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

# the families whose forward pass this module ports; the rest of the zoo
# (MoE, SSM, audio, VLM) is later work (ROADMAP.md)
PORTED_FAMILIES = ("dense",)


def signatures(cfg: ModelConfig) -> list:
    """(mixer kind, has_moe) per layer — the reference's layer signatures."""
    kinds = cfg.layer_kinds()
    return [(kinds[i], cfg.layer_has_moe(i)) for i in range(cfg.num_layers)]


def layer_plan(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_prefix_singles, period, n_repeats) of the reference's stacked
    parameter layout; n_prefix + period * n_repeats == num_layers."""
    sigs = signatures(cfg)
    LY = len(sigs)
    for p in range(1, min(8, LY) + 1):
        for k in range(0, min(4, LY)):
            tail = sigs[k:]
            if tail and len(tail) % p == 0 and all(
                    tail[i] == tail[i % p] for i in range(len(tail))):
                return k, p, len(tail) // p
    return LY, 1, 0


def _normal(gen, shape, scale, device, dtype):
    return (torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32) * scale).to(dtype)


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        if self.cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"family {self.cfg.family!r} is not ported yet (ported: "
                f"{', '.join(PORTED_FAMILIES)}); see ROADMAP.md")

    # ---- init -------------------------------------------------------------------------
    def init(self, generator: torch.Generator, dtype=torch.float32) -> dict:
        """Random parameters with the reference's shapes and scales
        (``repro.models.model.Model.init``), drawn on the generator's device.
        ``jax.random`` and torch draw different numbers, so compare with the
        reference only through ``convert.params_from_reference``."""
        cfg = self.cfg
        device = generator.device
        d, H, KV, hd, F = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                           cfg.head_dim, cfg.d_ff)
        ones = lambda n: torch.ones((n,), device=device, dtype=dtype)   # noqa: E731
        zeros = lambda n: torch.zeros((n,), device=device, dtype=dtype)  # noqa: E731
        nrm = lambda shape, sc: _normal(generator, shape, sc, device, dtype)  # noqa: E731
        params = {"embed": nrm((cfg.vocab_size, d), 1.0 / math.sqrt(d)),
                  "final_norm": ones(d)}
        if not cfg.tie_embeddings:
            params["unembed"] = nrm((d, cfg.vocab_size), 1.0 / math.sqrt(d))
        layers = []
        for _ in range(cfg.num_layers):
            mixer = {"wq": nrm((d, H * hd), 1.0 / math.sqrt(d)),
                     "wk": nrm((d, KV * hd), 1.0 / math.sqrt(d)),
                     "wv": nrm((d, KV * hd), 1.0 / math.sqrt(d)),
                     "wo": nrm((H * hd, d), 1.0 / math.sqrt(H * hd))}
            if cfg.qkv_bias:
                mixer.update(bq=zeros(H * hd), bk=zeros(KV * hd), bv=zeros(KV * hd))
            if cfg.qk_norm:
                mixer.update(q_norm=ones(hd), k_norm=ones(hd))
            blk = {"norm1": ones(d), "mixer": mixer}
            if F > 0:
                blk["norm2"] = ones(d)
                blk["ffn"] = {"w_gate": nrm((d, F), 1.0 / math.sqrt(d)),
                              "w_up": nrm((d, F), 1.0 / math.sqrt(d)),
                              "w_down": nrm((F, d), 1.0 / math.sqrt(F))}
            layers.append(blk)
        params["layers"] = layers
        return params

    def _unembed(self, params, x):
        w = params["embed"].T if self.cfg.tie_embeddings else params["unembed"]
        return x @ w

    def _ffn(self, bp, x):
        if "ffn" in bp:
            x = x + L.apply_mlp(bp["ffn"], L.rms_norm(x, bp["norm2"],
                                                      self.cfg.norm_eps))
        return x

    # ---- decode state -----------------------------------------------------------------
    def init_decode_state(self, batch: int, window: int, device=None,
                          dtype=torch.float32) -> list:
        cfg = self.cfg
        shape = (batch, window, cfg.num_kv_heads, cfg.head_dim)
        return [{"k": torch.zeros(shape, device=device, dtype=dtype),
                 "v": torch.zeros(shape, device=device, dtype=dtype)}
                for _ in range(cfg.num_layers)]

    @staticmethod
    def _ring(W: int, pos, batch: int, device):
        """(write_idx, cache_len) of a decode step at ``pos``: an int or a
        (B,) tensor of absolute positions. cache_len is (B,) int32."""
        if isinstance(pos, torch.Tensor):
            pos = pos.to(device)
            return pos % W, torch.clamp(pos + 1, max=W).to(torch.int32)
        return int(pos) % W, torch.full((batch,), min(int(pos) + 1, W),
                                        dtype=torch.int32, device=device)

    # ---- decode (serving path) --------------------------------------------------------
    def decode_step(self, params, state: list, token: torch.Tensor, pos):
        """token (B,) ints; pos an int shared by the batch, or per-slot (B,)
        positions. -> (logits (B, V), new state)."""
        cfg = self.cfg
        x = params["embed"][token.long()][:, None]                 # (B, 1, d)
        B = x.shape[0]
        W = state[0]["k"].shape[1]
        write_idx, cache_len = self._ring(W, pos, B, x.device)
        rope = L.rope_tables(L.decode_positions(pos, B, x.device), cfg.head_dim,
                             cfg.rope_theta)
        new_state = []
        for bp, st in zip(params["layers"], state):
            h = L.rms_norm(x, bp["norm1"], cfg.norm_eps)
            h, k_new, v_new = L.apply_self_attention_decode(
                bp["mixer"], cfg, h, pos, st["k"], st["v"], cache_len, write_idx,
                rope=rope)
            x = self._ffn(bp, x + h)
            new_state.append({"k": k_new, "v": v_new})
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self._unembed(params, x)[:, 0], new_state

    # ---- prefill ----------------------------------------------------------------------
    def prefill(self, params, tokens: torch.Tensor, *, window_cache: int = 0,
                dtype=torch.float32):
        """Full-sequence walk that also builds the decode state.

        tokens (B, S). Returns (last_logits (B, V), state list, next_pos S).
        The default window leaves 512 slots of headroom, as the reference
        does; when S > W only the last W positions are kept, rolled so that
        position p sits at ring index p % W."""
        cfg = self.cfg
        tokens = tokens.long()
        B, S = tokens.shape
        W = window_cache or (S + 512)
        x = params["embed"][tokens]
        rope = L.rope_tables(torch.arange(S, device=x.device)[None],
                             cfg.head_dim, cfg.rope_theta)
        state = []
        take = min(W, S)
        for bp in params["layers"]:
            h = L.rms_norm(x, bp["norm1"], cfg.norm_eps)
            q, k, v = L.self_attention_qkv(bp["mixer"], cfg, h, rope)
            kv = []
            for t in (k, v):
                t = t[:, S - take:].to(dtype)
                if take < W:
                    t = torch.cat([t, t.new_zeros((B, W - take) + t.shape[2:])], 1)
                if S > W:
                    t = torch.roll(t, S % W, dims=1)
                kv.append(t.contiguous())
            state.append({"k": kv[0], "v": kv[1]})
            x = self._ffn(bp, x + L.attend_full(bp["mixer"], q, k, v))
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self._unembed(params, x[:, -1:])[:, 0], state, S


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
