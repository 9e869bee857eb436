"""End-to-end serving entry point of the port (the paper's workloads).

    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
        --retriever edr --retriever-backend kernel --mode both --concurrency 4

Builds the synthetic Wikipedia-like corpus, the EDR, ADR or SR retriever, the
GPT-2-medium class host LM (reduced to 2 layers unless ``--full-width``), and
serves QA-style requests with RaLMSeq (baseline) and/or RaLMSpec, printing the
paper-style G/R latency decomposition. ``--concurrency N`` (N > 1) serves the
speculative side through the fleet: a BatchedServeEngine with N slots and a
FleetServer that merges every slot's verification queries into one batched KB
call per round. With ``--mode both`` it prints whether the outputs are
identical to the sequential baseline.

``--workload knnlm`` serves KNN-LM (paper §5.3) instead: the KB is a
(context -> next token) datastore over the corpus token stream, one retrieval
per generated token, KNNLMSeq against KNNLMSpec or the fleet, and ``--mode
both`` prints ``outputs token-match``. With ``--full-width`` it serves the
paper's KNN-LM model (knnlm-247m) as published over a datastore of every
context of the ``--n-docs`` stream.

``--scheduler continuous`` serves through ContinuousFleetServer: requests sit
on a modeled arrival timeline (Poisson at ``--arrival-rate``, or
``--arrival-trace "0,0.5,1.2"`` / ``@FILE``) and are admitted into engine
slots the moment slots free up; ``--max-queue-depth`` / ``--queue-deadline``
shed what cannot be served in time. ``--inject-faults
'p_error=0.2,seed=3'`` wraps the retriever's KB path in the seeded chaos
harness (``repro_torch.retrieval.faults``; fleet schedulers and ``--mode
spec`` only), with ``--retry-max`` / ``--retry-backoff`` /
``--retrieval-timeout`` configuring the retry shell:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --workload knnlm --scheduler continuous --concurrency 4 \
        --requests 8 --arrival-rate 2

``--retriever-backend sharded`` (or ``int8-sharded``) cuts the KB into
``--mesh-shards N`` shards, each scanned by its own kernel launch, and merges
them in one call per round (``repro_torch.retrieval.sharded``: a single
controller over the visible cards, all shards on the one card of an H100
host; 0 means one shard a card):

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --retriever-backend sharded --mesh-shards 4 --concurrency 2

An audio model (whisper-base) takes its encoder frames through the engine:
``make_server(stack, engine=ServeEngine(..., extra={"frames": f}))``, as in
the reference; the CLI has no flag for it.

Everything runs on ``--device`` (default ``cuda``; ``cpu`` runs the kernels'
plain PyTorch versions). The capability table below lists what the port
runs, the reference's own; everything else is rejected by
:func:`validate_stack`, naming what is supported.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import RaLMConfig, get_config, reduced
from repro_torch.core.cache import SharedRetrievalCache
from repro_torch.core.knnlm import KNNLMSeq, KNNLMSpec
from repro_torch.core.ralmspec import RaLMSeq, RaLMSpec
from repro_torch.models.model import build_model
from repro_torch.retrieval.backends import BACKENDS
from repro_torch.retrieval.encoder import ContextEncoder
from repro_torch.retrieval.faults import inject_faults, parse_fault_spec
from repro_torch.retrieval.kb import DenseKB, SparseKB, build_knn_datastore
from repro_torch.retrieval.retrievers import (BM25Retriever, ExactDenseRetriever,
                                              IVFRetriever)
from repro_torch.serving.batched import BatchedServeEngine
from repro_torch.serving.continuous import ContinuousFleetServer, as_requests
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.fleet import FleetServer
from repro_torch.serving.workload import Workload, default_workload
from repro_torch.training.data import make_queries, synthetic_corpus

WORKLOADS = ("ralm", "knnlm")
SCHEDULERS = ("seq", "single", "fixed", "continuous")

# The capability table: (workload, retriever) -> supported execution
# backends. Every listed cell runs under every scheduler in SCHEDULERS. SR's
# BM25 term scan has a single (numpy) execution strategy. KNN-LM has no SR
# cell: its datastore must carry per-entry next-token values, which a BM25
# SparseKB does not.
CAPABILITIES = {
    ("ralm", "edr"): BACKENDS,
    ("ralm", "adr"): BACKENDS,
    ("ralm", "sr"): ("numpy",),
    ("knnlm", "edr"): BACKENDS,
    ("knnlm", "adr"): BACKENDS,
}


def validate_stack(workload: str, retriever: str, backend: str = "numpy",
                   scheduler: str = "fixed") -> None:
    """THE error path for serving-stack capability: every rejection raises
    ValueError here, naming the valid set."""
    if workload not in WORKLOADS:
        raise ValueError(f"unknown workload {workload!r} "
                         f"(supported: {', '.join(WORKLOADS)})")
    if scheduler not in SCHEDULERS:
        raise ValueError(f"unknown scheduler {scheduler!r} "
                         f"(supported: {', '.join(SCHEDULERS)})")
    if (workload, retriever) not in CAPABILITIES:
        sup = [r for (w, r) in CAPABILITIES if w == workload]
        raise ValueError(
            f"workload {workload!r} does not support retriever {retriever!r} "
            f"(supported: {', '.join(sup)})")
    sup = CAPABILITIES[(workload, retriever)]
    if backend not in sup:
        raise ValueError(
            f"retriever {retriever!r} does not support backend {backend!r} "
            f"(supported: {', '.join(sup)})")


@dataclasses.dataclass
class ServeStack:
    """Everything a serving run needs, by name — the return of
    :func:`build_stack` and the one argument :func:`make_server` takes."""

    cfg: object
    model: object
    params: object
    docs: list
    encoder: ContextEncoder
    retriever: object
    rcfg: RaLMConfig
    workload: Workload
    retriever_kind: str = "edr"
    backend: str = "numpy"
    shared_cache: object = None
    stream: object = None              # KNN-LM token stream (None for ralm)
    engine: object = None              # cached by make_server


def build_stack(retriever: str, *, n_docs: int = 20000,
                arch: str = "ralm-gpt2-medium", backend: str = "numpy",
                mesh_shards: int = 0, seed: int = 0, enc_dim: int = 64, d_model: int = 256,
                workload: str = "ralm", rcfg: RaLMConfig = None,
                shared_cache=None, knn_entries: Optional[int] = 20000,
                device=None, full_width: bool = False) -> ServeStack:
    """Model + corpus + retriever + workload, validated against the
    capability table. The defaults build the reference's reduced stack
    (2 layers, d_model 256, vocab 512); ``full_width=True`` builds ``arch``
    exactly as published. ``arch`` may name any config of the registry:
    dense, MoE, SSM, hybrid, VLM and audio models are served (an audio
    model's frames reach its prefills through the engine's ``extra``).
    ``mesh_shards`` is the sharded backends' shard count (0: one shard a
    visible card). Parameters come from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (default CUDA).

    With ``workload='knnlm'`` the KB is a (context -> next token) datastore
    over the corpus token stream (``knn_entries`` caps its size, None takes
    every context; the stream is returned on the stack for prompt
    construction) and the retriever runs over the datastore keys — the same EDR/ADR and backends, other rows."""
    validate_stack(workload, retriever, backend)
    dev = resolve_device(device)
    rcfg = dataclasses.replace(RaLMConfig() if rcfg is None else rcfg,
                               knnlm=(workload == "knnlm"))
    cfg = get_config(arch) if full_width else \
        reduced(get_config(arch), layers=2, d_model=d_model)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen)
    docs = synthetic_corpus(n_docs, cfg.vocab_size)
    stream = None
    if workload == "knnlm":
        stream = np.concatenate([np.asarray(d, np.int32) for d in docs])
        enc = ContextEncoder(cfg.vocab_size, d=enc_dim, window=16)
        kb = build_knn_datastore(stream, enc, context=16, limit=knn_entries)
    else:
        enc = ContextEncoder(cfg.vocab_size, d=enc_dim)
        kb = SparseKB.build(docs) if retriever == "sr" else DenseKB.build(docs, enc)
    if retriever == "sr":
        retr = BM25Retriever(kb)
    elif retriever == "edr":
        retr = ExactDenseRetriever(kb, backend=backend, device=dev, mesh_shards=mesh_shards)
    else:
        retr = IVFRetriever(kb, backend=backend, device=dev, mesh_shards=mesh_shards)
    return ServeStack(cfg=cfg, model=model, params=params, docs=docs,
                      encoder=enc, retriever=retr, rcfg=rcfg,
                      workload=default_workload(rcfg),
                      retriever_kind=retriever, backend=backend,
                      shared_cache=shared_cache, stream=stream)


def make_server(stack: ServeStack, *, scheduler: str = "fixed",
                n_slots: int = 1, cache_window: int = 512,
                async_fleet=None, engine=None):
    """THE server factory: ``seq`` (the per-request sequential baseline),
    ``single`` (single-request speculation), ``fixed`` (FleetServer lockstep
    groups of ``n_slots``) or ``continuous`` (ContinuousFleetServer admitting
    mid-flight); the stack's workload picks the algorithm (RaLM or KNN-LM)
    within it. Engines are cached on ``stack.engine`` and reused when the
    type and slot count match; pass ``engine=`` to override."""
    validate_stack(stack.workload.name, stack.retriever_kind, stack.backend,
                   scheduler)
    knn = stack.workload.name == "knnlm"
    if scheduler in ("seq", "single"):
        eng = engine if engine is not None else stack.engine
        if not isinstance(eng, ServeEngine):
            eng = ServeEngine(stack.model, stack.params,
                              cache_window=cache_window)
            stack.engine = eng
        if scheduler == "seq":
            cls = KNNLMSeq if knn else RaLMSeq
            return cls(eng, stack.retriever, stack.rcfg, stack.encoder)
        if knn:
            return KNNLMSpec(eng, stack.retriever, stack.rcfg, stack.encoder)
        return RaLMSpec(eng, stack.retriever, stack.rcfg, stack.encoder,
                        shared_cache=stack.shared_cache)
    beng = engine if engine is not None else stack.engine
    if not (isinstance(beng, BatchedServeEngine) and beng.n_slots == n_slots):
        beng = BatchedServeEngine(stack.model, stack.params, n_slots,
                                  cache_window=cache_window)
        stack.engine = beng
    cls = ContinuousFleetServer if scheduler == "continuous" else FleetServer
    return cls(beng, stack.retriever, stack.rcfg, stack.encoder,
               async_rounds=async_fleet, shared_cache=stack.shared_cache,
               workload=stack.workload)


def variant_config(variant: str, base: RaLMConfig) -> RaLMConfig:
    """'', 'p', 's', 'a', 'ps', 'sa', 'pa', 'psa' — paper Table 1/4 naming."""
    return dataclasses.replace(
        base,
        prefetch_top_k=20 if "p" in variant else 1,
        use_os3="s" in variant,
        async_verification="a" in variant,
    )


def make_arrivals(n: int, rate: float, trace: str = "", seed: int = 0):
    """Arrival times on the modeled clock: a trace beats a rate beats all-at-0.

    ``trace`` is comma-separated seconds, or ``@path`` naming a file with one
    arrival time per line (blank lines and ``#`` comments ignored); either
    form is cycled/truncated to n. ``rate`` > 0 draws Poisson arrivals
    (exponential inter-arrival gaps, rate req/s). Malformed traces raise
    ``ValueError`` with a one-line message — the CLI maps it to an argparse
    error instead of a traceback."""
    if trace:
        text = trace
        if trace.startswith("@"):
            path = trace[1:]
            try:
                with open(path) as fh:
                    text = ",".join(line.split("#", 1)[0] for line in fh)
            except OSError as e:
                raise ValueError(
                    f"cannot read arrival trace file {path!r}: {e}") from None
        pts = []
        for x in text.replace("\n", ",").split(","):
            x = x.strip()
            if not x:
                continue
            try:
                pts.append(float(x))
            except ValueError:
                raise ValueError(f"malformed arrival time {x!r} "
                                 "(want seconds as a float)") from None
        if not pts:
            raise ValueError("arrival trace is empty")
        if any(p < 0 for p in pts):
            raise ValueError("arrival times must be >= 0")
        return [pts[i % len(pts)] for i in range(n)]
    if rate > 0:
        gaps = np.random.default_rng(seed).exponential(1.0 / rate, size=n)
        return np.cumsum(gaps).tolist()
    return [0.0] * n


def main() -> None:
    ap = argparse.ArgumentParser(allow_abbrev=False)
    ap.add_argument("--workload", default="ralm",
                    help="ralm: iterative RaLM (Algorithm 1, byte-parity); "
                         "knnlm: KNN-LM serving (per-token datastore "
                         "retrieval, token-match parity — paper §5.3)")
    ap.add_argument("--retriever", default="edr",
                    help="edr (exact dense scan), adr (IVF probe) or sr "
                         "(BM25; ralm only, numpy backend)")
    ap.add_argument("--mode", choices=["seq", "spec", "both"], default="both")
    ap.add_argument("--variant", default="psa",
                    help="subset of 'psa': prefetch / OS3 scheduler / async")
    ap.add_argument("--requests", "--num-requests", dest="requests", type=int,
                    default=5, help="number of requests to serve")
    ap.add_argument("--max-new", type=int, default=48)
    ap.add_argument("--n-docs", type=int, default=20000)
    ap.add_argument("--enc-dim", type=int, default=64,
                    help="embedding width of the KB (DPR: 768)")
    ap.add_argument("--stride", type=int, default=3)
    ap.add_argument("--concurrency", type=int, default=1,
                    help=">1: serve the speculative path through the fleet "
                         "(batched engine + cross-request batched verification)")
    ap.add_argument("--scheduler", default="fixed",
                    help="fixed: groups of --concurrency in lockstep; "
                         "continuous: admit into freed slots mid-flight")
    ap.add_argument("--async-fleet", action="store_true",
                    help="pipeline fleet rounds: overlap the merged "
                         "verification KB call with the next lockstep "
                         "speculation stride (implied by a variant containing 'a')")
    ap.add_argument("--retriever-backend", default="numpy",
                    help="dense scoring backend: numpy, kernel (the CUDA "
                         "scans, KB resident on the device), sharded (the KB "
                         "cut into --mesh-shards shards, a CUDA scan each), "
                         "int8 (numpy over the int8 KB), int8-kernel (the "
                         "CUDA int8 scans) or int8-sharded")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the model's random parameters and of the "
                         "Poisson arrivals")
    ap.add_argument("--shared-cache", action="store_true",
                    help="put a fleet-scale shared speculation cache tier in "
                         "front of the KB (speculation-only, so outputs stay "
                         "byte-identical to the baseline)")
    ap.add_argument("--shared-cache-capacity", type=int, default=65536,
                    help="entries held by the shared cache tier (LRU)")
    ap.add_argument("--retry-max", type=int, default=2,
                    help="KB-call retries (after the first attempt) on the "
                         "fleet verification/seed paths")
    ap.add_argument("--retry-backoff", type=float, default=0.0,
                    help="base exponential backoff in seconds between KB-call "
                         "retries (retry i sleeps base*2^(i-1))")
    ap.add_argument("--retrieval-timeout", type=float, default=0.0,
                    help="per-KB-call deadline in seconds (0 = none)")
    ap.add_argument("--inject-faults", default="",
                    help="chaos harness: seeded fault schedule for the KB "
                         "path, e.g. 'p_error=0.2,p_spike=0.1,spike_s=0.05,"
                         "seed=3' (also error_calls/spike_calls=i;j;..., "
                         "max_faults=n). Requires --mode spec on a fleet "
                         "scheduler")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="continuous: Poisson arrival rate, requests per "
                         "modeled second (0 = all requests arrive at t=0)")
    ap.add_argument("--arrival-trace", default="",
                    help="continuous: comma-separated arrival times in "
                         "modeled seconds, or @FILE with one per line "
                         "(overrides --arrival-rate)")
    ap.add_argument("--max-queue-depth", type=int, default=0,
                    help="continuous: arrived requests allowed to wait for a "
                         "slot before the newest are shed (0 = unbounded)")
    ap.add_argument("--queue-deadline", type=float, default=0.0,
                    help="continuous: queueing-delay deadline in modeled "
                         "seconds past which a waiting request is shed")
    ap.add_argument("--mesh-shards", type=int, default=0,
                    help="shard count of the sharded backends (0 = one shard "
                         "per visible card; any N, several shards a card "
                         "where N exceeds the cards, on the CPU all on it)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--full-width", action="store_true",
                    help="serve the workload's model exactly as published "
                         "(ralm: ralm-gpt2-medium, 24 layers; knnlm: knnlm-247m, "
                         "16 layers, over every context of the --n-docs stream) "
                         "instead of the reduced 2-layer stack")
    args = ap.parse_args()
    try:
        validate_stack(args.workload, args.retriever, args.retriever_backend,
                       args.scheduler)
        device = resolve_device(args.device)
    except (ValueError, RuntimeError) as e:
        ap.error(str(e))
    if args.mesh_shards < 0:
        ap.error("--mesh-shards must be >= 0")
    arrivals = None
    if args.scheduler == "continuous":
        try:
            arrivals = make_arrivals(args.requests, args.arrival_rate,
                                     args.arrival_trace, args.seed)
        except ValueError as e:
            ap.error(f"--arrival-trace: {e}")
    fault_spec = None
    if args.inject_faults:
        try:
            fault_spec = parse_fault_spec(args.inject_faults)
        except ValueError as e:
            ap.error(f"--inject-faults: {e}")
        # only the fleet paths have the retry / degradation shell
        if args.mode != "spec":
            ap.error("--inject-faults requires --mode spec (the RaLMSeq "
                     "baseline has no fault-tolerance shell)")
        if args.scheduler != "continuous" and args.concurrency <= 1:
            ap.error("--inject-faults requires a fleet scheduler: use "
                     "--concurrency > 1 or --scheduler continuous (the "
                     "single-request path has no fault-tolerance shell)")

    rcfg = variant_config(args.variant.replace("-", ""),
                          RaLMConfig(max_new_tokens=args.max_new,
                                     speculation_stride=args.stride,
                                     retry_max=args.retry_max,
                                     retry_backoff_s=args.retry_backoff,
                                     retrieval_timeout_s=args.retrieval_timeout,
                                     max_queue_depth=args.max_queue_depth,
                                     queue_deadline_s=args.queue_deadline))
    shared = (SharedRetrievalCache(capacity=args.shared_cache_capacity)
              if args.shared_cache else None)
    # the reduced stacks are the reference's (ralm-gpt2-medium cut to 2
    # layers, a 20,000-entry datastore); full width serves the workload's
    # published model, KNN-LM over the whole stream
    full_knn = args.full_width and args.workload == "knnlm"
    stack = build_stack(args.retriever, n_docs=args.n_docs,
                        arch="knnlm-247m" if full_knn else "ralm-gpt2-medium",
                        backend=args.retriever_backend,
                        mesh_shards=args.mesh_shards, seed=args.seed,
                        enc_dim=args.enc_dim, workload=args.workload, rcfg=rcfg,
                        shared_cache=shared,
                        knn_entries=None if full_knn else 20000,
                        device=device, full_width=args.full_width)
    retr = stack.retriever
    kb = retr.kb
    kb_shape = (f"{kb.size} x {kb.embeddings.shape[1]}" if hasattr(kb, "embeddings")
                else f"{kb.size} docs (BM25)")
    be = getattr(retr, "backend", None)
    backend = getattr(be, "name", "numpy")
    if backend.endswith("sharded"):
        backend += f" ({be.n_shards} shards on {', '.join(sorted(set(map(str, be.devices))))})"
    print(f"device {device} ({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'host'}), "
          f"model {stack.cfg.name}: {stack.cfg.num_layers} layers, "
          f"d_model {stack.cfg.d_model}, vocab {stack.cfg.vocab_size}; "
          f"{retr.name} backend {backend}, KB {kb_shape}")
    inj = inject_faults(retr, fault_spec) if fault_spec is not None else None
    if args.workload == "knnlm":
        # KNN-LM prompts are spans of the datastore's own token stream
        prompts = [stack.stream[i * 97:i * 97 + 48].tolist()
                   for i in range(args.requests)]
    else:
        prompts = [(q * 12)[:48] for q in make_queries(stack.docs, args.requests)]

    def run(server, label):
        tot_w = tot_g = tot_r = 0.0
        toks = []
        for p in prompts:
            r = server.serve(p)
            tot_w += r.wall_time
            tot_g += r.gen_time
            tot_r += r.retrieval_time
            toks.append(r.tokens)
        print(f"{label:14s} wall {tot_w:7.2f}s  G {tot_g:6.2f}s  R {tot_r:6.2f}s")
        return tot_w, toks

    async_rounds = True if args.async_fleet else None  # None: follow variant

    def degradation_line(res) -> None:
        """One line of fault-tolerance accounting when anything fired."""
        if not (res.kb_errors or res.kb_timeouts or res.kb_failures
                or res.degraded_rounds or res.worker_crashes
                or res.seed_failures or getattr(res, "shed", 0)):
            return
        print(f"{'fault ledger':14s} retried {res.kb_errors} errors + "
              f"{res.kb_timeouts} timeouts; {res.kb_failures} calls failed "
              f"for good -> {res.degraded_rounds} degraded rounds "
              f"({res.degraded_requests} requests), {res.worker_crashes} "
              f"worker crashes recovered, {res.seed_failures} seed calls "
              f"lost, {getattr(res, 'shed', 0)} requests shed")

    def run_fleet(label):
        tot_w = tot_an = 0.0
        toks, n_tok = [], 0
        with make_server(stack, scheduler="fixed", n_slots=args.concurrency,
                         async_fleet=async_rounds) as fleet:
            for i in range(0, len(prompts), args.concurrency):
                fr = fleet.serve(prompts[i:i + args.concurrency])
                tot_w += fr.wall_time
                tot_an += fr.analytic_time
                n_tok += fr.total_tokens
                toks.extend(r.tokens for r in fr.results)
                degradation_line(fr)
        print(f"{label:14s} wall {tot_w:7.2f}s  modeled {tot_an:6.2f}s  "
              f"throughput {n_tok / max(tot_an, 1e-9):8.1f} tok/s (modeled)")
        return tot_w, toks

    def run_continuous(label):
        with make_server(stack, scheduler="continuous",
                         n_slots=args.concurrency,
                         async_fleet=async_rounds) as server:
            cr = server.serve(as_requests(prompts, arrivals))
        print(f"{label:14s} wall {cr.wall_time:7.2f}s  "
              f"modeled makespan {cr.analytic_time:6.2f}s  "
              f"throughput {cr.throughput():8.1f} tok/s (modeled)  "
              f"p50 {cr.p50:.2f}s  p99 {cr.p99:.2f}s  "
              f"peak live {cr.max_live}")
        degradation_line(cr)
        return cr.wall_time, [r.tokens for r in cr.results]

    knn = args.workload == "knnlm"
    results = {}
    if args.mode in ("seq", "both"):
        results["seq"] = run(make_server(stack, scheduler="seq"),
                             "KNNLMSeq" if knn else "RaLMSeq")
    if args.mode in ("spec", "both"):
        base = "KNNLMSpec" if knn else "RaLMSpec"
        label = base + ("+" + args.variant.upper() if args.variant else "")
        if args.scheduler == "continuous":
            results["spec"] = run_continuous(f"Continuous x{args.concurrency}")
        elif args.concurrency > 1:
            results["spec"] = run_fleet(f"Fleet x{args.concurrency}")
        else:
            results["spec"] = run(make_server(stack, scheduler="single"), label)
    if len(results) == 2:
        same = all(a == b for a, b in zip(results["seq"][1], results["spec"][1]))
        kind = ("outputs token-match" if stack.workload.equivalence ==
                "token-match" else "outputs identical")
        print(f"{kind}: {same}   "
              f"speed-up {results['seq'][0] / max(results['spec'][0], 1e-9):.2f}x")
    if shared is not None:
        st = shared.stats()
        print(f"shared cache: {st['hits_exact']} exact + "
              f"{st['hits_approx']} approx hits / {st['lookups']} lookups "
              f"({st['hit_rate']:.0%} hit rate), {st['size']} entries")
    if inj is not None:
        print(f"fault injection: {inj.errors} errors + {inj.spikes} spikes "
              f"over {inj.calls} KB scans (seed {inj.spec.seed}); "
              f"retried {retr.stats.errors + retr.stats.timeouts} attempts, "
              f"{retr.stats.failed_calls} calls failed after retries")


if __name__ == "__main__":
    main()
