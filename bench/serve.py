"""The system under test, assembled from the run's own inputs, and the
measured window.

The stack is the port's own serving path: ``repro_torch.launch.serve``'s
``ServeStack`` and ``make_server(scheduler="fixed")``, a FleetServer over a
BatchedServeEngine, an ExactDenseRetriever on the ``kernel`` backend (B1)
and the port's model (B2, B3), built from the weights, encoder table and KB
that ``bench.data`` made from the seed.

:class:`Recorder` wraps calls into each layer at run time, from the
benchmark's side (no program file is edited): in every run it keeps a
sample, drawn from the seed, of the merged KB calls and of the logits the
model hands on (``prefill``: a prefill's last logits; ``step``: the logits
of decode steps through the ring cache, read where KNN-LM interpolates and
after each RaLM stride), for the comparison after the window. A traced run serves, after the window, a few more groups
under ``torch.profiler`` (so the window's own counters and host clocks are
read untraced), records a host span around each call there (``fleet.round``,
``engine.prefill``, ``engine.decode``, ``kb.call``, ``knn.interpolate``) and
the shapes the kernel rooflines need.
"""
from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

MODEL_KEYS = ("family", "num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
              "d_ff", "vocab_size", "qkv_bias", "qk_norm", "rope_theta", "norm_eps",
              "tie_embeddings")
OPTIONAL_MODEL_KEYS = ("moe_layer_rule", "sliding_window")
LOGIT_KINDS = ("prefill", "step")
LOGIT_SAMPLE = 32        # logits rows kept of each kind
TRACE_SECONDS = 8.0      # a traced run profiles groups for this long after the window


class Reservoir:
    """A uniform sample of at most ``size`` items of a stream, drawn from
    ``rng``; ``offer`` says whether the next item is taken, so an item is
    copied only when kept."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng, self.seen, self.items = size, rng, 0, []
        self._lock = threading.Lock()

    def offer(self):
        """-> a slot index for the next item, or None to drop it."""
        with self._lock:
            self.seen += 1
            if len(self.items) < self.size:
                self.items.append(None)
                return len(self.items) - 1
            j = int(self.rng.integers(0, self.seen))
            return j if j < self.size else None

    def put(self, slot: int, item) -> None:
        self.items[slot] = item


@dataclass
class Recorder:
    seed: int
    kb_calls: Reservoir = None
    logits: dict = None                                 # kind -> Reservoir
    spec_steps: list = field(default_factory=list)      # (verified, kept) per slot-round
    kb_shapes: list = field(default_factory=list)       # (B, k) per call, traced
    decode_lens: list = field(default_factory=list)     # per decode step, traced
    spans: list = field(default_factory=list)           # (label, thread, t0_ns, t1_ns), traced
    active: bool = False                                # inside the traced part

    def __post_init__(self):
        rng = np.random.default_rng([self.seed, 0x5A3])
        self.kb_calls = Reservoir(16, rng)
        self.logits = {k: Reservoir(LOGIT_SAMPLE, rng) for k in LOGIT_KINDS}

    @contextlib.contextmanager
    def _span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, threading.get_native_id(), t0, time.time_ns()))

    def span(self, name: str):
        """A host span of the traced part, on the clock of the profiler's
        timestamps (Unix ns); nothing outside it."""
        return self._span(name) if self.active else contextlib.nullcontext()

    def start_window(self) -> None:
        """Sample and count the window's calls only, not the warm-up's."""
        self.kb_calls = Reservoir(self.kb_calls.size, self.kb_calls.rng)
        self.logits = {k: Reservoir(r.size, r.rng) for k, r in self.logits.items()}
        self.spec_steps.clear()

    def keep_logits(self, kind: str, context_fn, logits_fn) -> None:
        res = self.logits[kind]
        slot = res.offer()
        if slot is not None:
            res.put(slot, (list(context_fn()), np.asarray(logits_fn(), np.float32)))


def recorded_model(model_cls, cfg, rec: Recorder):
    """The port's model class with its two public serving entries recorded."""

    class Recorded(model_cls):
        def prefill(self, params, tokens, **kw):
            with rec.span("engine.prefill"):
                out = super().prefill(params, tokens, **kw)
            rec.keep_logits("prefill", lambda: tokens[0].tolist(),
                            lambda: out[0][0].cpu().numpy())
            return out

        def decode_step(self, params, state, token, pos):
            if rec.active:
                p = pos.cpu().tolist() if isinstance(pos, torch.Tensor) else [int(pos)]
                rec.decode_lens.append(p)
            with rec.span("engine.decode"):
                return super().decode_step(params, state, token, pos)

    return Recorded(cfg)


def port_config(cfg: dict):
    """The port's model config of a configuration file: every model field
    the file states, as the file states it (``moe`` and ``ssm`` objects as
    their sub-configs, ``block_pattern`` as a tuple)."""
    from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig
    kw = {k: cfg[k] for k in MODEL_KEYS}
    kw.update({k: cfg[k] for k in OPTIONAL_MODEL_KEYS if k in cfg})
    if "moe" in cfg:
        kw["moe"] = MoEConfig(**cfg["moe"])
    if "ssm" in cfg:
        kw["ssm"] = SSMConfig(**cfg["ssm"])
    if "block_pattern" in cfg:
        kw["block_pattern"] = tuple(cfg["block_pattern"])
    return ModelConfig(name=cfg["name"], **kw)


def build(cfg: dict, corpus, device, rec: Recorder, n_slots: int):
    """-> (the port's ServeStack over the run's inputs, its recorded
    n_slots engine), the model built from the file's own model keys."""
    from repro_torch.configs import RaLMConfig
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import ServeStack, variant_config
    from repro_torch.models.model import Model
    from repro_torch.retrieval.encoder import ContextEncoder
    from repro_torch.retrieval.kb import DenseKB
    from repro_torch.retrieval.retrievers import ExactDenseRetriever
    from repro_torch.serving.batched import BatchedServeEngine
    from repro_torch.serving.workload import default_workload

    if torch.device(device).type == "cuda":
        _build.build_all()
    port_cfg = port_config(cfg)
    knn = cfg["workload"] == "knnlm"
    rcfg = variant_config(cfg["variant"], RaLMConfig(
        knnlm=knn, knn_k=cfg.get("knn_k", 8), knn_lambda=cfg.get("knn_lambda", 0.25),
        knn_prefetch_next_n=cfg.get("knn_next_n", 10),
        generation_stride=cfg.get("generation_stride", 4),
        speculation_stride=cfg["speculation_stride"]))
    enc = ContextEncoder(cfg["vocab_size"], d=1, window=cfg["encoder_window"],
                         decay=cfg["encoder_decay"])
    enc.table, enc.d = corpus.table, corpus.table.shape[1]
    kb = DenseKB(embeddings=corpus.keys, docs=corpus.docs, values=corpus.values)
    retr = ExactDenseRetriever(kb, backend=cfg["backend"], device=device)
    model = recorded_model(Model, port_cfg, rec)
    stack = ServeStack(cfg=port_cfg, model=model, params=corpus.params, docs=corpus.docs,
                       encoder=enc, retriever=retr, rcfg=rcfg,
                       workload=default_workload(rcfg), retriever_kind=cfg["retriever"],
                       backend=cfg["backend"])
    eng = BatchedServeEngine(model, corpus.params, n_slots, cache_window=cfg["cache_window"])
    _instrument(rec, eng, retr, stack.workload)
    return stack, eng


def _instrument(rec: Recorder, eng, retr, workload) -> None:
    retrieve, peek, commit = retr.retrieve, eng.peek_logits, workload.check_and_commit
    gen = eng.gen

    def retrieve_rec(queries, k):
        with rec.span("kb.call"):
            ids, scores = retrieve(queries, k)
        q = np.atleast_2d(np.asarray(queries, np.float32))
        if rec.active:
            rec.kb_shapes.append((len(q), int(k)))
        slot = rec.kb_calls.offer()
        if slot is not None:
            rec.kb_calls.put(slot, (q.copy(), int(k), np.array(ids), np.array(scores)))
        return ids, scores

    def context(slot):
        return list(eng.doc[slot]) + list(eng.tokens[slot])

    def peek_rec(slot):
        out = peek(slot)
        rec.keep_logits("step", lambda: context(slot), lambda: out)
        return out

    def gen_rec(slots, ks):
        out = gen(slots, ks)
        for b, new in zip(slots, out):
            if new:
                rec.keep_logits("step", lambda: context(b), lambda: peek(b))
        return out

    def commit_rec(srv, st, gt_ids, gt_scores):
        m, corr = commit(srv, st, gt_ids, gt_scores)
        rec.spec_steps.append((len(st.specs), m))
        return m, corr

    retr.retrieve, eng.peek_logits, workload.check_and_commit = retrieve_rec, peek_rec, commit_rec
    eng.gen = gen_rec


@contextlib.contextmanager
def traced_layers(rec: Recorder, server):
    """Spans around the fleet round and KNN-LM's interpolation (traced runs),
    restored on exit."""
    import repro_torch.serving.workload as W
    interp, run_round = W.knn_interpolate, getattr(server, "_run_round", None)

    def interp_rec(*a, **kw):
        with rec.span("knn.interpolate"):
            return interp(*a, **kw)

    def round_rec(*a, **kw):
        with rec.span("fleet.round"):
            return run_round(*a, **kw)

    W.knn_interpolate = interp_rec
    if run_round is not None:
        server._run_round = round_rec
    try:
        yield
    finally:
        W.knn_interpolate = interp


@dataclass
class Window:
    """What the measured window served, as the program reported it."""

    start: float = 0.0
    end: float = 0.0
    requests: list = field(default_factory=list)     # {prompt, tokens, max_new, status}
    groups: list = field(default_factory=list)       # per-group counters
    kb_time: float = 0.0
    kb_calls: int = 0
    spec_steps: list = field(default_factory=list)   # (verified, kept) per slot-round
    kb_sample: list = field(default_factory=list)    # (queries, k, ids, scores)
    logit_sample: dict = field(default_factory=dict)  # kind -> [(context, logits)]
    busy_s: float = None                             # the card's busy seconds (NVML)

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def tokens(self) -> int:
        return sum(len(r["tokens"]) for r in self.requests)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def serve_group(server, eng, group) -> tuple:
    prompts, max_new = [p for p, _ in group], [n for _, n in group]
    fr = server.serve(prompts, max_new=max_new)
    reqs = [dict(prompt=list(p), tokens=list(r.tokens), max_new=n, status=r.status)
            for p, n, r in zip(prompts, max_new, fr.results)]
    counters = dict(kb_calls=fr.kb_calls, gen_time=fr.results[0].gen_time if fr.results else 0.0,
                    prefills=eng.stats.prefills, rounds=fr.rounds, wall=fr.wall_time)
    return reqs, counters


def run_window(server, eng, retr, groups, seconds: float, device, rec: Recorder,
               meter=None) -> Window:
    """Closed loop: the next group is sent when the last returns, from the
    window's start until ``seconds`` have passed; the window ends with the
    last group that started in it. The samples for the comparison are taken
    from the window's calls only. ``meter`` (a ``bench.nvml.BusyMeter``)
    reads the card's busy share over the window."""
    w = Window()
    rec.start_window()
    s0, c0 = retr.stats.time, retr.stats.calls
    _sync(device)
    if meter is not None:
        meter.start()
    w.start = time.monotonic()
    while time.monotonic() - w.start < seconds:
        reqs, counters = serve_group(server, eng, next(groups))
        w.requests += reqs
        w.groups.append(counters)
    _sync(device)
    w.end = time.monotonic()
    if meter is not None:
        share = meter.stop()
        w.busy_s = None if share is None else share * w.seconds
    w.kb_time, w.kb_calls = retr.stats.time - s0, retr.stats.calls - c0
    w.spec_steps = list(rec.spec_steps)
    w.kb_sample = [c for c in rec.kb_calls.items if c is not None]
    w.logit_sample = {k: [c for c in r.items if c is not None] for k, r in rec.logits.items()}
    return w


def run_traced(server, eng, groups, device, rec: Recorder, profiler) -> tuple:
    """After the window, the groups that start in the next TRACE_SECONDS,
    under ``profiler`` (a ``torch.profiler.profile`` of the device only,
    whose host cost is a fraction of one that records every host op); the
    spans and the shapes the rooflines need are recorded meanwhile.
    -> (the finished profiler, (start_ns, end_ns) of the traced part)."""
    _sync(device)
    profiler.__enter__()
    rec.active = True
    t0 = time.time_ns()
    while True:
        serve_group(server, eng, next(groups))
        if time.time_ns() - t0 >= TRACE_SECONDS * 1e9:
            break
    _sync(device)
    t1 = time.time_ns()
    rec.active = False
    profiler.__exit__(None, None, None)
    return profiler, (t0, t1)
