"""Model assembly for every family the serving path runs (the reference's
``repro.models.model.Model``): dense, MoE, SSM (xLSTM), hybrid (Jamba:
Mamba, attention and MoE), VLM (PaliGemma: image patches as a
bidirectional prefix) and audio (Whisper: an encoder over precomputed frame
embeddings, and a decoder with cross-attention over its output).
``init``, ``encode``, ``forward`` (the full-sequence pass that training
runs), ``init_decode_state``, ``prefill`` and ``decode_step`` (serving's),
and ``init_decode_state_stacked`` / ``decode_step_stacked`` (the dry-run's
decode, over a state stacked as the reference stacks its layers).

``forward`` takes its attention route from the caller: with
``differentiable=True`` (the train step) every self-attention, the audio
encoder's included, runs ``layers.apply_self_attention`` (plain or
blockwise, as the reference trains), which autograd differentiates; with
``differentiable=False`` (eval, ``last_only``) it runs ``layers.attend_full``,
the B3 kernel on the card, which has no backward and refuses inputs that
require grad. Its MoE layers run the capacity dispatch (``moe.apply_moe``),
as the reference's ``forward`` does; prefill and decode run the dropless one.

Parameters are a plain dict: ``embed`` (V, d), ``final_norm`` (d,),
``unembed`` (d, V) unless embeddings are tied, and ``layers``, one dict per
layer: ``norm1``, ``mixer`` (attention {wq, wk, wv, wo[, bq, bk, bv][,
q_norm, k_norm]}, or a Mamba / mLSTM / sLSTM mixer from ``models.ssm``),
and ``norm2`` with ``moe`` (``models.moe``) or ``ffn`` {w_gate, w_up,
w_down} where the layer has one; an audio decoder layer also has
``norm_cross`` and ``cross`` (attention leaves), and an audio model an
``encoder`` {``layers`` (self-attention blocks), ``final_norm``}. The
reference stacks its layers for ``lax.scan``; ``repro_torch.models.convert``
unstacks them.

The decode state is a list with one dict per layer: ``{"k", "v"}`` ring
caches (B, W, KV, hd) for attention, ``{"ssm": {...}}`` for a recurrent
mixer, and for an audio decoder ``"cross_k"``/``"cross_v"`` (B, frames,
KV, hd), the encoder memory's K/V that prefill projects once. Every method
returns new tensors and never writes into the state it was given, so a
state held by an engine snapshot stays valid; no decode step writes the
cross K/V, so a step hands the same tensors on and snapshots share them.
On the card ``decode_step`` replays a CUDA graph of the step
(``DecodeGraph``) under the same contract.

The stacked decode state has the reference's layout: ``{"prefix": tuple of
layer states, "stages": tuple}``, stage j holding the states of layers
``n_pre + r * period + j`` (:func:`layer_plan`) stacked along a leading
``n_rep`` axis when the period repeats more than once. Its parameters stay
the unstacked ``params["layers"]``. Its MoE layers run the capacity dispatch,
as the reference's ``decode_step_stacked`` does (``exact_moe=False``).
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import mesh_ops as M
from repro_torch.distributed.sharding import Spec
from repro_torch.kernels import decode_attention as DA
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

# the families whose serving path this module ports: every family of the
# registry
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
# the families whose decode step replays from a CUDA graph on the card
# (``DecodeGraph``): those whose graphed step is tested bit-equal to the eager
# one there (tests/test_torch_gpu.py); a family added later stays eager until
# it is tested and listed
GRAPH_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


class _Recurrent(NamedTuple):
    """A recurrent mixer kind's functions (``models.ssm``)."""
    init: Callable            # (gen, cfg, dtype) -> params
    apply: Callable           # (params, cfg, x (B, S, d)) -> (B, S, d)
    init_state: Callable      # (cfg, batch, device, dtype) -> state
    step: Callable            # (params, cfg, x (B, 1, d), state) -> (out, state)
    final_state: Callable     # (params, cfg, x (B, S, d)) -> state after x


_RECURRENT = {
    "mamba": _Recurrent(SSM.init_mamba, SSM.apply_mamba, SSM.init_mamba_state,
                        SSM.apply_mamba_step, SSM.mamba_final_state),
    "mlstm": _Recurrent(SSM.init_mlstm, SSM.apply_mlstm, SSM.init_mlstm_state,
                        SSM.apply_mlstm_step, SSM.mlstm_final_state),
    "slstm": _Recurrent(SSM.init_slstm, SSM.apply_slstm, SSM.init_slstm_state,
                        SSM.apply_slstm_step, SSM.slstm_final_state),
}


def signatures(cfg: ModelConfig) -> list:
    """(mixer kind, has_moe) per layer — the reference's layer signatures."""
    kinds = cfg.layer_kinds()
    return [(kinds[i], cfg.layer_has_moe(i)) for i in range(cfg.num_layers)]


def layer_plan(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_prefix_singles, period, n_repeats) of the reference's stacked
    parameter layout; n_prefix + period * n_repeats == num_layers. A hybrid
    stacks its period (Jamba: 8 layers); kimi-k2's dense first layer is a
    single in the prefix."""
    sigs = signatures(cfg)
    LY = len(sigs)
    for p in range(1, min(8, LY) + 1):
        for k in range(0, min(4, LY)):
            tail = sigs[k:]
            if tail and len(tail) % p == 0 and all(
                    tail[i] == tail[i % p] for i in range(len(tail))):
                return k, p, len(tail) // p
    return LY, 1, 0


def _init_block(gen, cfg: ModelConfig, sig, dtype, cross: bool = False) -> dict:
    kind, has_moe = sig
    d = cfg.d_model
    ones = torch.ones((d,), dtype=dtype, device=gen.device)
    p = {"norm1": ones,
         "mixer": (L.init_attention(gen, cfg, dtype) if kind == "attn"
                   else _RECURRENT[kind].init(gen, cfg, dtype))}
    if cross:
        p.update(norm_cross=ones.clone(), cross=L.init_attention(gen, cfg, dtype, cross=True))
    if has_moe:
        p.update(norm2=ones.clone(), moe=MOE.init_moe(gen, cfg, dtype))
    elif cfg.d_ff > 0:
        p.update(norm2=ones.clone(), ffn=L.init_mlp(gen, d, cfg.d_ff, dtype))
    return p


def _init_layer_state(cfg: ModelConfig, sig, batch: int, window: int, device,
                      dtype) -> dict:
    kind = sig[0]
    if kind == "attn":
        shape = (batch, window, cfg.num_kv_heads, cfg.head_dim)
        st = {"k": torch.zeros(shape, device=device, dtype=dtype),
              "v": torch.zeros(shape, device=device, dtype=dtype)}
    else:
        st = {"ssm": _RECURRENT[kind].init_state(cfg, batch, device, dtype)}
    if cfg.family == "audio":
        shape = (batch, cfg.encoder_frames, cfg.num_kv_heads, cfg.head_dim)
        st.update(cross_k=torch.zeros(shape, device=device, dtype=dtype),
                  cross_v=torch.zeros(shape, device=device, dtype=dtype))
    return st


def _add(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The residual add of a sublayer's output ``h``. On a mesh ``h`` is
    first placed as the reference constrains a block's output
    (``Spec(BATCH, None, None)``): a partial sum left by a contraction over
    'model' is reduced where it is made, as the reference's partitioner
    reduces at the product, and not carried into the next products, which
    would then run whole on every 'model' rank."""
    return x + M.shard(h, M.BLOCK)


def _final_state(mp: dict, cfg: ModelConfig, kind: str, h: torch.Tensor) -> dict:
    """The recurrent state after consuming h (B, S, d), stepping token by
    token from the zero state as decode does (the reference's stepwise
    ``lax.scan``), for the decode steps that follow a prefill."""
    return _RECURRENT[kind].final_state(mp, cfg, h)


class DecodeGraph:
    """One decode step captured in a CUDA graph, for one params, batch,
    window and device: what ``Model.decode_step`` replays after the first
    step of that key, which runs eagerly and captures it.

    Its static inputs are the token (B,), the positions (B,) and a copy of
    every state leaf; the captured step updates the state copy in place (the
    ring write goes straight into the static K/V, a recurrent state is
    copied back into its buffer at the step's end) and leaves the logits
    (B, V) in a static output. The kernels and their order are the eager
    step's, so a replay's logits and state are bit-equal to it.

    A call keeps ``decode_step`` a pure function: it copies the given state
    into the static buffers, but for each leaf that is the very tensor the
    last replay returned, unwritten since (its ``_version``), so a straight
    run of steps copies nothing in and a restore, a prefill's scatter or a
    masked commit does; and it returns a clone of the logits and of every
    leaf the step writes, handing on a leaf it does not write (an audio
    decoder's cross K/V) as the caller gave it. ``replays`` and ``copies``
    count replays and the calls that copied a leaf in; ``DA.launches``
    counts each replay's B2 launches, as an eager step's."""

    def __init__(self, model: "Model", params, state: list, token: torch.Tensor):
        dev, B = token.device, token.shape[0]
        self.params = params                  # the weights the graph reads stay alive
        self.replays = self.copies = 0
        self._token = torch.zeros((B,), dtype=torch.long, device=dev)
        self._pos = torch.zeros((B,), dtype=torch.long, device=dev)
        self._state = tree_map(torch.clone, state)
        self._leaves = tree_leaves(self._state)
        versions = [t._version for t in self._leaves]
        launches = DA.launches
        self._graph = torch.cuda.CUDAGraph()
        # thread-local: the verification worker may launch meanwhile
        with torch.cuda.graph(self._graph, capture_error_mode="thread_local"):
            self._logits, out = model._decode(params, self._state, self._token, self._pos,
                                              inplace=True)
            for buf, new in zip(self._leaves, tree_leaves(out)):
                if new is not buf:
                    buf.copy_(new)
        self._b2, DA.launches = DA.launches - launches, launches      # captured, not run
        self._written = [t._version != v for t, v in zip(self._leaves, versions)]
        self._last: list = []                 # (weakref, _version) of each leaf returned

    def __call__(self, state: list, token: torch.Tensor, pos):
        leaves = tree_leaves(state)
        last, copied = self._last, False
        for i, (buf, leaf) in enumerate(zip(self._leaves, leaves)):
            if not (last and last[i][0]() is leaf and leaf._version == last[i][1]):
                buf.copy_(leaf)
                copied = True
        self.copies += copied
        self._token.copy_(token)
        if isinstance(pos, torch.Tensor):
            self._pos.copy_(pos)
        else:
            self._pos.fill_(int(pos))
        self._graph.replay()
        self.replays += 1
        DA.launches += self._b2
        out = [buf.clone() if w else leaf
               for buf, leaf, w in zip(self._leaves, leaves, self._written)]
        self._last = [(weakref.ref(t), t._version) for t in out]
        return self._logits.clone(), tree_unflatten(state, out)


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    # (batch, window, device) -> the DecodeGraph of the params last stepped there
    _graphs: dict = field(default_factory=dict, init=False, repr=False, compare=False)

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
        d = cfg.d_model
        params = {"embed": L.normal(generator, (cfg.vocab_size, d), d ** -0.5, dtype),
                  "final_norm": torch.ones((d,), dtype=dtype, device=generator.device)}
        if not cfg.tie_embeddings:
            params["unembed"] = L.normal(generator, (d, cfg.vocab_size), d ** -0.5, dtype)
        cross = cfg.family == "audio"
        params["layers"] = [_init_block(generator, cfg, sig, dtype, cross)
                            for sig in signatures(cfg)]
        if cross:
            params["encoder"] = {
                "layers": [_init_block(generator, cfg, ("attn", False), dtype)
                           for _ in range(cfg.encoder_layers)],
                "final_norm": torch.ones((d,), dtype=dtype, device=generator.device)}
        return params

    # ---- encoder (audio) --------------------------------------------------------------
    def encode(self, params, frames: torch.Tensor, *,
               differentiable: bool = False) -> torch.Tensor:
        """frames (B, F, d): the precomputed frame embeddings of the stubbed
        conv frontend, as in the reference -> the encoder's output (B, F,
        d): sinusoidal positions, then bidirectional self-attention blocks
        (B3 with ``causal=False``, or ``apply_self_attention`` when
        ``differentiable``) and a final norm."""
        cfg = self.cfg
        enc = params["encoder"]
        x = frames.to(device=enc["final_norm"].device, dtype=enc["final_norm"].dtype)
        x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model, x.device).to(x.dtype)
        positions = torch.arange(x.shape[1], device=x.device)[None]
        rope = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        for bp in enc["layers"]:
            bp = M.gather_fsdp(bp, x)
            h = L.rms_norm(x, bp["norm1"], cfg.norm_eps)
            if differentiable:
                x = _add(x, L.apply_self_attention(bp["mixer"], cfg, h, positions,
                                                      causal=False))
            else:
                q, k, v = L.self_attention_qkv(bp["mixer"], cfg, h, rope)
                x = _add(x, L.attend_full(bp["mixer"], q, k, v, causal=False))
            x = self._ffn(bp, x)
        return L.rms_norm(x, enc["final_norm"], cfg.norm_eps)

    # ---- full-sequence forward (training) -----------------------------------------------
    def forward(self, params, tokens: torch.Tensor, *, extra: Optional[dict] = None,
                window: int = 0, last_only: bool = False, remat: bool = False,
                differentiable: bool = False):
        """tokens (B, S_text) -> (logits (B, S, V), aux loss), the reference's
        ``Model.forward``: S counts a VLM's ``extra["patches"]`` (a
        bidirectional prefix); an audio model encodes ``extra["frames"]``.
        ``last_only`` unembeds the last position only. ``remat`` recomputes
        each block in the backward pass instead of keeping its activations
        (``torch.utils.checkpoint``, non-reentrant). ``differentiable``
        picks the attention route (module docstring): True for a pass that
        autograd differentiates, False for B3. The aux loss is the sum of
        the MoE layers' router losses."""
        cfg = self.cfg
        x, prefix_len = self._embed_inputs(params, tokens.long(), extra)
        mem = None
        if cfg.family == "audio":
            mem = self.encode(params, extra["frames"], differentiable=differentiable)
        positions = torch.arange(x.shape[1], device=x.device)[None]
        rope = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        x = M.shard(x, M.BLOCK)

        def block(bp, sig, x):
            return self._block(bp, sig, x, positions, rope, mem=mem, window=window,
                               prefix_len=prefix_len, differentiable=differentiable)

        aux = x.new_zeros((), dtype=torch.float32)
        for bp, sig in zip(params["layers"], signatures(cfg)):
            x, a = (checkpoint(block, bp, sig, x, use_reentrant=False) if remat
                    else block(bp, sig, x))
            aux = aux + a
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        if last_only:
            x = x[:, -1:]
        return M.shard(self._unembed(params, x), Spec(M.BATCH, None, "model")), aux

    def _block(self, bp, sig, x, positions, rope, *, mem=None, window=0, prefix_len=0,
               differentiable=False):
        """One layer of the full-sequence pass (the reference's
        ``_apply_block``) -> (x, the layer's MoE aux loss): the mixer
        (self-attention by the route ``differentiable`` names, or a
        recurrent mixer's full sequence), the audio cross-attention over
        ``mem``, then the capacity MoE or the FFN."""
        cfg = self.cfg
        bp = M.gather_fsdp(bp, x)
        h = L.rms_norm(x, bp["norm1"], cfg.norm_eps)
        if sig[0] != "attn":
            h = _RECURRENT[sig[0]].apply(bp["mixer"], cfg, h)
        elif differentiable:
            h = L.apply_self_attention(bp["mixer"], cfg, h, positions, window=window,
                                       prefix_len=prefix_len)
        else:
            q, k, v = L.self_attention_qkv(bp["mixer"], cfg, h, rope)
            h = L.attend_full(bp["mixer"], q, k, v, window=window, prefix_len=prefix_len)
        x = _add(x, h)
        if mem is not None:
            x = self._cross(bp, x, *L.project_memory_kv(bp["cross"], cfg, mem))
        aux = x.new_zeros((), dtype=torch.float32)
        if "moe" in bp:
            h, aux = MOE.apply_moe(bp["moe"], cfg, L.rms_norm(x, bp["norm2"], cfg.norm_eps))
            x = _add(x, h)
        elif "ffn" in bp:
            x = _add(x, L.apply_mlp(bp["ffn"], L.rms_norm(x, bp["norm2"], cfg.norm_eps)))
        return M.shard(x, M.BLOCK), aux

    def _cross(self, bp, x, mem_k, mem_v):
        """x plus the block's cross-attention over the memory K/V."""
        h = L.rms_norm(x, bp["norm_cross"], self.cfg.norm_eps)
        return _add(x, L.apply_cross_attention(bp["cross"], self.cfg, h, mem_k, mem_v))

    def _unembed(self, params, x):
        w = params["embed"].T if self.cfg.tie_embeddings else params["unembed"]
        return x @ M.gather_fsdp(w, x)

    def _ffn(self, bp, x, exact: bool = True):
        """The block's second half: the MoE (the dropless one, serving's exact
        form, or with ``exact=False`` the capacity dispatch) or the SwiGLU
        FFN, after its norm; layers with neither pass x through."""
        if "moe" in bp:
            moe = MOE.apply_moe_exact if exact else MOE.apply_moe
            h, _ = moe(bp["moe"], self.cfg, L.rms_norm(x, bp["norm2"], self.cfg.norm_eps))
            return _add(x, h)
        if "ffn" in bp:
            x = _add(x, L.apply_mlp(bp["ffn"], L.rms_norm(x, bp["norm2"], self.cfg.norm_eps)))
        return x

    def _embed_inputs(self, params, tokens, extra: Optional[dict]):
        """Token embeddings; a VLM's ``extra["patches"]`` (B, P, d) go in
        front as a prefix that attends both ways; a model without rope adds
        sinusoidal positions. -> (x, prefix_len)."""
        x = M.gather_fsdp(params["embed"], tokens)[tokens]
        prefix_len = 0
        if self.cfg.family == "vlm" and extra is not None and "patches" in extra:
            patches = extra["patches"].to(device=x.device, dtype=x.dtype)
            x, prefix_len = torch.cat([patches, x], dim=1), patches.shape[1]
        if self.cfg.rope_theta <= 0:
            x = x + L.sinusoidal_positions(x.shape[1], self.cfg.d_model, x.device).to(x.dtype)
        return x, prefix_len

    # ---- decode state -----------------------------------------------------------------
    def init_decode_state(self, batch: int, window: int, device=None,
                          dtype=torch.float32) -> list:
        return [_init_layer_state(self.cfg, sig, batch, window, device, dtype)
                for sig in signatures(self.cfg)]

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
        positions. -> (logits (B, V), new state). Recurrent layers step
        their state.

        On a CUDA device, with grad off, no DTensor and a family of
        :data:`GRAPH_FAMILIES`, the step replays from a CUDA graph
        (:class:`DecodeGraph`), one for each batch, window and device: the
        first step there runs eagerly and then captures it (an engine's
        ``warm`` makes that step), and so does a step with other params,
        whose graph replaces the one before. Elsewhere every step runs
        eagerly."""
        key = self._graph_key(state, token, pos)
        graph = self._graphs.get(key) if key is not None else None
        if graph is not None and graph.params is params:
            return graph(state, token, pos)
        out = self._decode(params, state, token, pos)
        if key is not None and not M.is_distributed(*tree_leaves(params)):
            self._graphs[key] = DecodeGraph(self, params, state, token)
        return out

    def decode_graph(self, params, state: list) -> Optional[DecodeGraph]:
        """The graph a decode step over ``params`` and ``state`` replays,
        once one is captured (its counters: :class:`DecodeGraph`)."""
        g = self._graphs.get(self._state_key(state))
        return g if g is not None and g.params is params else None

    def _graph_key(self, state, token, pos):
        """The key of the step's graph, or None where it stays eager."""
        if (self.cfg.family not in GRAPH_FAMILIES or token.device.type != "cuda"
                or torch.is_grad_enabled() or torch.is_inference_mode_enabled()
                or M.is_distributed(token, pos, *tree_leaves(state[0]))):
            return None
        return self._state_key(state)

    @staticmethod
    def _state_key(state):
        first = tree_leaves(state[0])[0]
        window = next((st["k"].shape[1] for st in state if "k" in st), 0)
        return first.shape[0], window, first.device

    def _decode(self, params, state: list, token: torch.Tensor, pos, inplace: bool = False):
        """The eager decode step (``inplace``: the ring writes go into the
        given K/V, as :class:`DecodeGraph` captures it)."""
        x = self._decode_embed(params, token, pos)
        shared: dict = {}
        new_state = []
        for bp, sig, st in zip(params["layers"], signatures(self.cfg), state):
            x, st = self._decode_block(bp, sig, x, st, pos, shared, inplace=inplace)
            new_state.append(st)
        return self._decode_logits(params, x), new_state

    def init_decode_state_stacked(self, batch: int, window: int, device=None,
                                  dtype=torch.float32) -> dict:
        """The decode state in the reference's stacked layout (module
        docstring): a repeated stage's leaves get a leading ``n_rep`` axis,
        each repeat its own copy of the initial state."""
        cfg = self.cfg
        n_pre, period, n_rep = layer_plan(cfg)
        sigs = signatures(cfg)
        prefix = tuple(_init_layer_state(cfg, sigs[i], batch, window, device, dtype)
                       for i in range(n_pre))
        stages = []
        for j in range(period if n_rep else 0):
            one = _init_layer_state(cfg, sigs[n_pre + j], batch, window, device, dtype)
            if n_rep > 1:
                one = tree_map(lambda t: t.unsqueeze(0).repeat(
                    (n_rep,) + (1,) * t.ndim), one)
            stages.append(one)
        return {"prefix": prefix, "stages": tuple(stages)}

    def unstack_decode_state(self, state: dict) -> list:
        """A stacked decode state as the per-layer list ``decode_step``
        takes: layer ``n_pre + r * period + j`` is ``state["stages"][j][r]``
        (views of the stacked leaves)."""
        n_pre, period, n_rep = layer_plan(self.cfg)
        flat = list(state["prefix"])
        for r in range(n_rep):
            for j in range(period):
                stage = state["stages"][j]
                flat.append(stage if n_rep == 1 else tree_map(lambda t: t[r], stage))
        return flat

    def stack_decode_state(self, flat: list) -> dict:
        """The inverse of :meth:`unstack_decode_state`: each stage's leaves
        ``torch.stack``ed over the repeats into new tensors."""
        n_pre, period, n_rep = layer_plan(self.cfg)
        stages = tuple(flat[n_pre + j] if n_rep == 1 else
                       tree_map(lambda *xs: torch.stack(xs), *flat[n_pre + j::period])
                       for j in range(period if n_rep else 0))
        return {"prefix": tuple(flat[:n_pre]), "stages": stages}

    def decode_step_stacked(self, params, state: dict, token: torch.Tensor, pos):
        """The reference's ``decode_step_stacked``: one decode step over the
        stacked state (:meth:`init_decode_state_stacked`), layer by layer
        over :meth:`unstack_decode_state`'s views, MoE layers through the
        capacity dispatch. token (B,) ints; pos an int or per-slot (B,)
        positions. -> (logits (B, V), new stacked state, from
        :meth:`stack_decode_state`: nothing of ``state`` is written)."""
        sigs = signatures(self.cfg)
        x = self._decode_embed(params, token, pos)
        shared: dict = {}
        new = []
        for i, st in enumerate(self.unstack_decode_state(state)):
            x, st = self._decode_block(params["layers"][i], sigs[i], x, st, pos, shared,
                                       exact_moe=False)
            new.append(st)
        return self._decode_logits(params, x), self.stack_decode_state(new)

    def _decode_embed(self, params, token, pos):
        """The step's input (B, 1, d): token embeddings, plus sinusoidal
        positions for a model without rope."""
        x = M.gather_fsdp(params["embed"], token)[token.long()][:, None]
        if self.cfg.rope_theta <= 0:
            x = x + L.sinusoid_at(L.decode_positions(pos, x.shape[0], x.device),
                                  self.cfg.d_model).to(x.dtype)
        return x

    def _decode_logits(self, params, x):
        x = L.rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return self._unembed(params, x)[:, 0]

    def _decode_block(self, bp, sig, x, st, pos, shared: dict, exact_moe: bool = True,
                      inplace: bool = False):
        """One layer of a decode step (the reference's ``_apply_block_decode``)
        -> (x, the layer's new state). ``shared`` holds the step's ring
        (write_idx, cache_len) and rope tables, made at its first attention
        layer from that layer's window (every attention layer has the same
        one; a model may have none, or start with a recurrent layer)."""
        cfg = self.cfg
        bp = M.gather_fsdp(bp, x)
        h = L.rms_norm(x, bp["norm1"], cfg.norm_eps)
        if sig[0] == "attn":
            if not shared:
                B = x.shape[0]
                shared["ring"] = self._ring(st["k"].shape[1], pos, B, x.device)
                shared["rope"] = L.rope_tables(L.decode_positions(pos, B, x.device),
                                               cfg.head_dim, cfg.rope_theta)
            write_idx, cache_len = shared["ring"]
            h, k_new, v_new = L.apply_self_attention_decode(
                bp["mixer"], cfg, h, pos, st["k"], st["v"], cache_len, write_idx,
                rope=shared["rope"], inplace=inplace)
            st = dict(st, k=k_new, v=v_new)
        else:
            h, ssm = _RECURRENT[sig[0]].step(bp["mixer"], cfg, h, st["ssm"])
            st = dict(st, ssm=ssm)
        x = _add(x, h)
        if "cross_k" in st:            # the step hands the memory K/V on as they are
            x = self._cross(bp, x, st["cross_k"], st["cross_v"])
        return self._ffn(bp, x, exact=exact_moe), st

    # ---- prefill ----------------------------------------------------------------------
    def prefill(self, params, tokens: torch.Tensor, *, extra: Optional[dict] = None,
                window_cache: int = 0, dtype=torch.float32):
        """Full-sequence walk that also builds the decode state.

        tokens (B, S_text); a VLM may pass ``extra={"patches": (B, P, d)}``,
        and an audio model must pass ``extra={"frames": (B, F, d)}`` (its
        encoder runs on them, and every layer's cross K/V is projected from
        the encoder's output into new tensors). Returns (last_logits (B, V),
        state list, next_pos S), S counting the patches. The default window
        leaves 512 slots of headroom, as the
        reference does; when S > W only the last W positions are kept,
        rolled so that position p sits at ring index p % W. A recurrent
        layer's state is the one its decode step would reach after S
        tokens."""
        cfg = self.cfg
        x, prefix_len = self._embed_inputs(params, tokens.long(), extra)
        B, S = x.shape[0], x.shape[1]
        mem = None
        if cfg.family == "audio":
            if extra is None or "frames" not in extra:
                raise ValueError(f"{cfg.name}: prefill needs extra={{'frames': (B, F, d)}}")
            mem = self.encode(params, extra["frames"])
        W = window_cache or (S + 512)
        rope = L.rope_tables(torch.arange(S, device=x.device)[None],
                             cfg.head_dim, cfg.rope_theta)
        state = []
        take = min(W, S)
        for bp, sig in zip(params["layers"], signatures(cfg)):
            h = L.rms_norm(x, bp["norm1"], cfg.norm_eps)
            if sig[0] == "attn":
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
                h = L.attend_full(bp["mixer"], q, k, v, prefix_len=prefix_len)
            else:
                state.append({"ssm": _final_state(bp["mixer"], cfg, sig[0], h)})
                h = _RECURRENT[sig[0]].apply(bp["mixer"], cfg, h)
            x = _add(x, h)
            if mem is not None:
                mk, mv = L.project_memory_kv(bp["cross"], cfg, mem)
                state[-1].update(cross_k=mk.to(dtype), cross_v=mv.to(dtype))
                x = self._cross(bp, x, mk, mv)
            x = self._ffn(bp, x)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self._unembed(params, x[:, -1:])[:, 0], state, S


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
