"""Configuration system for repro_torch.

Every assigned architecture is expressed as a :class:`ModelConfig`. The config is a
plain frozen dataclass so it can be hashed into jit static args and printed into
EXPERIMENTS.md verbatim.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts sub-config (None on dense archs)."""

    num_experts: int
    top_k: int
    d_expert: int                  # per-expert FFN hidden dim
    num_shared_experts: int = 0    # always-on experts (qwen2-moe style)
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2
    # token chunk size for dispatch (bounds the (E, C, d) gather buffer)
    dispatch_chunk: int = 4096


@dataclass(frozen=True)
class SSMConfig:
    """State-space / recurrent sub-config (mamba + xlstm families)."""

    kind: str = "mamba"            # "mamba" | "mlstm" | "slstm"
    d_state: int = 16              # mamba SSM state dim
    d_conv: int = 4                # mamba local conv width
    expand: int = 2                # mamba inner expansion
    chunk: int = 256               # chunkwise-parallel scan chunk length


@dataclass(frozen=True)
class ModelConfig:
    """A single architecture, exactly as assigned from the public pool."""

    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0        # 0 -> full attention; >0 used for long_500k
    # norm / misc
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # sub-configs
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (jamba): per-layer block kinds, e.g. ("mamba",)*3+("attn",)+...
    block_pattern: Tuple[str, ...] = ()
    # layers at which MoE replaces the dense FFN ("every_2", "all", "none")
    moe_layer_rule: str = "all"
    # audio (whisper): encoder spec — decoder dims come from the main fields
    encoder_layers: int = 0
    encoder_frames: int = 0        # stub frontend: #frames of precomputed embeddings
    # vlm (paligemma): number of image patch embeddings prepended as prefix
    vision_patches: int = 0
    source: str = ""               # citation bracket from the assignment

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ---- derived quantities -------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def layer_kinds(self) -> Tuple[str, ...]:
        """Sequence-mixer kind per layer."""
        if self.block_pattern:
            reps = -(-self.num_layers // len(self.block_pattern))
            return (self.block_pattern * reps)[: self.num_layers]
        if self.family == "ssm":
            assert self.ssm is not None
            if self.ssm.kind == "xlstm":
                # xLSTM paper interleaves sLSTM blocks sparsely among mLSTM blocks
                # (1:7 in the 350M configuration table).
                return tuple(
                    "slstm" if (i % 8 == 7) else "mlstm" for i in range(self.num_layers)
                )
            return (self.ssm.kind,) * self.num_layers
        return ("attn",) * self.num_layers

    def layer_has_moe(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        if self.moe_layer_rule == "all":
            return True
        if self.moe_layer_rule == "every_2":
            return layer_idx % 2 == 1
        if self.moe_layer_rule == "dense_first":
            # kimi-k2 style: first layer dense, rest MoE
            return layer_idx >= 1
        return False

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks)."""
        d, hd = self.d_model, self.head_dim
        n_attn_per_layer = d * (self.num_heads + 2 * self.num_kv_heads) * hd + self.num_heads * hd * d
        ffn_dense = 3 * d * self.d_ff  # SwiGLU gate/up/down
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        kinds = self.layer_kinds()
        for i, kind in enumerate(kinds):
            if kind == "attn":
                total += n_attn_per_layer
            elif kind == "mamba":
                assert self.ssm is not None
                d_in = self.ssm.expand * d
                total += d * 2 * d_in + d_in * self.ssm.d_conv
                total += d_in * (self.ssm.d_state * 2 + 1) + d_in * d
            elif kind in ("mlstm", "slstm"):
                d_in = 2 * d
                total += d * d_in * 2 + 3 * d_in * hd + d_in * d  # rough proj count
            if self.layer_has_moe(i):
                m = self.moe
                total += (m.num_experts + m.num_shared_experts) * 3 * d * m.d_expert
                total += d * m.num_experts  # router
            elif self.d_ff > 0 and kind in ("attn", "mamba"):
                total += ffn_dense
            total += 2 * d  # norms
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only top-k + shared experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        full = self.param_count()
        n_moe_layers = sum(self.layer_has_moe(i) for i in range(self.num_layers))
        inactive = n_moe_layers * (m.num_experts - m.top_k) * 3 * self.d_model * m.d_expert
        return full - inactive


@dataclass(frozen=True)
class InputShape:
    """An assigned (seq_len, global_batch, step-kind) workload."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


@dataclass(frozen=True)
class SpeculationConfig:
    """Algorithm-1 speculation knobs (paper §3): stride schedule, prefetch,
    the speculation cache, and in-round verification dedup."""

    generation_stride: int = 4        # k: tokens generated per retrieval (Ram et al.)
    speculation_stride: int = 3       # s: spec steps per verification (fixed mode)
    use_os3: bool = False             # optimal speculation stride scheduler
    prefetch_top_k: int = 1           # 1 = top-1 cache update; 20/256 = prefetching
    # fleet-only: collapse byte-identical queries inside a round's merged
    # verification call before the collective — one KB row per unique query,
    # scattered back to slots. Output-invariant (retrieval is a pure function
    # of the query); FleetResult.merged_rows_saved counts the rows it saved.
    dedup_verification: bool = True
    os3_window: int = 5               # w for gamma estimation
    gamma_max: float = 0.6
    max_stride: int = 16
    cache_capacity: int = 4096


@dataclass(frozen=True)
class AsyncConfig:
    """Async (pipelined) verification knobs (paper §4, +A)."""

    async_verification: bool = False
    # adaptive overlap gate (single path's extra step AND the async fleet's
    # overlapped stride): only speculate under an in-flight verification when
    # the estimated verification latency exceeds ratio x a speculation step —
    # +A hurts cheap retrievers (ADR, paper Table 4), so 0 disables the gate
    # (always overlap) and a huge value disables the overlap itself.
    async_gate_ratio: float = 0.6
    # fleet-only: minimum overlapped sub-steps per round once the gate is
    # open, even past the verification window. The default 0 keeps the fleet
    # overlap strictly window-bounded (only sub-steps expected to hide under
    # b_est run, so an overlapped round can never cost more than a sync one
    # on the modeled timeline); tests raise it to force full-stride overlaps
    # deterministically on stacks whose retrieval is too cheap to hide work.
    async_min_overlap: int = 0


@dataclass(frozen=True)
class FaultConfig:
    """Fault tolerance on the fleet KB-call paths: retry with exponential
    backoff + a per-call deadline around the merged verification call
    (FleetServer._verify_merged) and the continuous seed / ride-along path.
    KB search is a pure function of the query (the invariant
    dedup_verification already rests on), so a retried call returns
    byte-identical rows — transient-fault recovery is output-preserving by
    construction (tests/test_faults.py)."""

    retry_max: int = 2                # retries after the first attempt
    retry_backoff_s: float = 0.0      # base backoff; retry i sleeps base*2^(i-1)
    # per-call deadline, 0 = none: a KB call that overruns it counts as timed
    # out, its rows are discarded, and the call is retried (determinism makes
    # the discard safe)
    retrieval_timeout_s: float = 0.0
    # a merged call that still fails after retries degrades the round to
    # speculation-only for its slots — affected requests are marked
    # status='degraded' and EXEMPT from byte-parity (the int8 exact-bit
    # pattern); False re-raises RetrievalFailed out of serve() instead
    degrade_on_failure: bool = True


@dataclass(frozen=True)
class QueueConfig:
    """Continuous-batching overload shedding: cap on ARRIVED requests allowed
    to wait for a slot (0 = unbounded; newest arrivals are turned away first,
    like a bounded admission queue), and a queueing-delay deadline past which
    a waiting request is retired with status='shed' rather than served long
    after its sender gave up (0 = none)."""

    max_queue_depth: int = 0
    queue_deadline_s: float = 0.0


# which nested sub-config each legacy flat knob lives in (the flat names are
# DEPRECATED aliases — see RaLMConfig)
_RALM_GROUPS = {
    "speculation": SpeculationConfig,
    "async_": AsyncConfig,
    "faults": FaultConfig,
    "queue": QueueConfig,
}
_RALM_GROUP_FIELDS = {
    g: tuple(f.name for f in dataclasses.fields(cls))
    for g, cls in _RALM_GROUPS.items()
}


@dataclass(frozen=True, init=False)
class RaLMConfig:
    """Serving-loop configuration for the paper's technique (§3–§4).

    Knobs are grouped into nested frozen sub-configs — ``speculation``
    (Algorithm-1 stride/prefetch/cache), ``async_`` (+A pipelining),
    ``faults`` (retry/deadline/degradation), ``queue`` (continuous-batching
    shedding) — plus the top-level generation and KNN-LM fields below.

    Back-compat: every sub-config field is also constructible and readable
    under its historical FLAT name (``RaLMConfig(speculation_stride=3)``,
    ``rcfg.async_gate_ratio``, ``dataclasses.replace(rcfg, use_os3=True)``)
    via ``__init__`` folding and read-only property aliases. The flat names
    are DEPRECATED: new code should pass/ read the nested groups
    (``rcfg.speculation.use_os3``)."""

    speculation: SpeculationConfig = SpeculationConfig()
    async_: AsyncConfig = AsyncConfig()
    faults: FaultConfig = FaultConfig()
    queue: QueueConfig = QueueConfig()
    # KNN-LM mode (§5.3)
    knnlm: bool = False
    knn_k: int = 8                    # neighbours interpolated
    knn_prefetch_next_n: int = 10     # spatial-locality cache update
    knn_lambda: float = 0.25          # interpolation weight
    # generation budget / shaping
    max_new_tokens: int = 128
    max_prompt_len: int = 512
    max_doc_len: int = 256

    def __init__(self, speculation: Optional[SpeculationConfig] = None,
                 async_: Optional[AsyncConfig] = None,
                 faults: Optional[FaultConfig] = None,
                 queue: Optional[QueueConfig] = None,
                 knnlm: bool = False, knn_k: int = 8,
                 knn_prefetch_next_n: int = 10, knn_lambda: float = 0.25,
                 max_new_tokens: int = 128, max_prompt_len: int = 512,
                 max_doc_len: int = 256, **flat):
        groups = {
            "speculation": speculation if speculation is not None
            else SpeculationConfig(),
            "async_": async_ if async_ is not None else AsyncConfig(),
            "faults": faults if faults is not None else FaultConfig(),
            "queue": queue if queue is not None else QueueConfig(),
        }
        # fold deprecated flat kwargs into their nested group
        for gname, fields in _RALM_GROUP_FIELDS.items():
            kw = {n: flat.pop(n) for n in fields if n in flat}
            if kw:
                groups[gname] = dataclasses.replace(groups[gname], **kw)
        if flat:
            raise TypeError(
                f"RaLMConfig got unexpected keyword argument(s): "
                f"{', '.join(sorted(flat))}")
        for gname, g in groups.items():
            object.__setattr__(self, gname, g)
        object.__setattr__(self, "knnlm", knnlm)
        object.__setattr__(self, "knn_k", knn_k)
        object.__setattr__(self, "knn_prefetch_next_n", knn_prefetch_next_n)
        object.__setattr__(self, "knn_lambda", knn_lambda)
        object.__setattr__(self, "max_new_tokens", max_new_tokens)
        object.__setattr__(self, "max_prompt_len", max_prompt_len)
        object.__setattr__(self, "max_doc_len", max_doc_len)


def _flat_alias(group: str, name: str) -> property:
    def get(self):
        return getattr(getattr(self, group), name)
    get.__doc__ = (f"DEPRECATED flat alias for ``{group}.{name}`` "
                   f"(kept for back-compat; prefer the nested field).")
    return property(get)


for _g, _names in _RALM_GROUP_FIELDS.items():
    for _n in _names:
        setattr(RaLMConfig, _n, _flat_alias(_g, _n))
del _g, _names, _n
