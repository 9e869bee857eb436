"""End-to-end RaLM serving entry point of the port (the paper's workload).

    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
        --retriever edr --retriever-backend kernel --mode both --concurrency 4

Builds the synthetic Wikipedia-like corpus, the EDR or ADR retriever, the GPT-2-medium
class host LM (reduced to 2 layers unless ``--full-width``), and serves
QA-style requests with RaLMSeq (baseline) and/or RaLMSpec, printing the
paper-style G/R latency decomposition. ``--concurrency N`` (N > 1) serves the
speculative side through the fleet: a BatchedServeEngine with N slots and a
FleetServer that merges every slot's verification queries into one batched KB
call per round. With ``--mode both`` it prints whether the outputs are
identical to the sequential baseline.

Everything runs on ``--device`` (default ``cuda``; ``cpu`` runs the kernels'
plain PyTorch versions). The capability table below lists what the port runs
today; everything else is rejected by :func:`validate_stack`, naming what is
supported.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.configs import RaLMConfig, get_config, reduced
from repro_torch.core.cache import SharedRetrievalCache
from repro_torch.core.ralmspec import RaLMSeq, RaLMSpec
from repro_torch.models.model import build_model
from repro_torch.retrieval.backends import BACKENDS
from repro_torch.retrieval.encoder import ContextEncoder
from repro_torch.retrieval.kb import DenseKB
from repro_torch.retrieval.retrievers import ExactDenseRetriever, IVFRetriever
from repro_torch.serving.batched import BatchedServeEngine
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.fleet import FleetServer
from repro_torch.serving.workload import Workload, default_workload
from repro_torch.training.data import make_queries, synthetic_corpus

WORKLOADS = ("ralm",)
SCHEDULERS = ("seq", "single", "fixed")

# The capability table: (workload, retriever) -> supported execution
# backends. Every listed cell runs under every scheduler in SCHEDULERS.
# SR, KNN-LM, the sharded backends and continuous batching are later slices
# (ROADMAP.md).
CAPABILITIES = {
    ("ralm", "edr"): BACKENDS,
    ("ralm", "adr"): BACKENDS,
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
    engine: object = None              # cached by make_server


def build_stack(retriever: str, *, n_docs: int = 20000,
                arch: str = "ralm-gpt2-medium", backend: str = "numpy",
                seed: int = 0, enc_dim: int = 64, d_model: int = 256,
                workload: str = "ralm", rcfg: RaLMConfig = None,
                shared_cache=None, device=None,
                full_width: bool = False) -> ServeStack:
    """Model + corpus + retriever + workload, validated against the
    capability table. The defaults build the reference's reduced stack
    (2 layers, d_model 256, vocab 512); ``full_width=True`` builds ``arch``
    exactly as published. Parameters come from a ``torch.Generator`` seeded
    with ``seed`` on ``device`` (default CUDA)."""
    validate_stack(workload, retriever, backend)
    dev = resolve_device(device)
    rcfg = RaLMConfig() if rcfg is None else rcfg
    cfg = get_config(arch) if full_width else \
        reduced(get_config(arch), layers=2, d_model=d_model)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen)
    docs = synthetic_corpus(n_docs, cfg.vocab_size)
    enc = ContextEncoder(cfg.vocab_size, d=enc_dim)
    kb = DenseKB.build(docs, enc)
    retr = (ExactDenseRetriever(kb, backend=backend, device=dev)
            if retriever == "edr" else IVFRetriever(kb, backend=backend, device=dev))
    return ServeStack(cfg=cfg, model=model, params=params, docs=docs,
                      encoder=enc, retriever=retr, rcfg=rcfg,
                      workload=default_workload(rcfg),
                      retriever_kind=retriever, backend=backend,
                      shared_cache=shared_cache)


def make_server(stack: ServeStack, *, scheduler: str = "fixed",
                n_slots: int = 1, cache_window: int = 512,
                async_fleet=None, engine=None):
    """THE server factory: ``seq`` (the RaLMSeq baseline), ``single``
    (single-request RaLMSpec) or ``fixed`` (FleetServer lockstep groups of
    ``n_slots``). Engines are cached on ``stack.engine`` and reused when the
    type and slot count match; pass ``engine=`` to override."""
    validate_stack(stack.workload.name, stack.retriever_kind, stack.backend,
                   scheduler)
    if scheduler in ("seq", "single"):
        eng = engine if engine is not None else stack.engine
        if not isinstance(eng, ServeEngine):
            eng = ServeEngine(stack.model, stack.params,
                              cache_window=cache_window)
            stack.engine = eng
        if scheduler == "seq":
            return RaLMSeq(eng, stack.retriever, stack.rcfg, stack.encoder)
        return RaLMSpec(eng, stack.retriever, stack.rcfg, stack.encoder,
                        shared_cache=stack.shared_cache)
    beng = engine if engine is not None else stack.engine
    if not (isinstance(beng, BatchedServeEngine) and beng.n_slots == n_slots):
        beng = BatchedServeEngine(stack.model, stack.params, n_slots,
                                  cache_window=cache_window)
        stack.engine = beng
    return FleetServer(beng, stack.retriever, stack.rcfg, stack.encoder,
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


def main() -> None:
    ap = argparse.ArgumentParser(allow_abbrev=False)
    ap.add_argument("--workload", default="ralm",
                    help="ralm: iterative RaLM (Algorithm 1, byte-parity)")
    ap.add_argument("--retriever", default="edr",
                    help="edr (exact dense scan) or adr (IVF probe)")
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
                    help="fixed: groups of --concurrency in lockstep")
    ap.add_argument("--async-fleet", action="store_true",
                    help="pipeline fleet rounds: overlap the merged "
                         "verification KB call with the next lockstep "
                         "speculation stride (implied by a variant containing 'a')")
    ap.add_argument("--retriever-backend", default="numpy",
                    help="dense scoring backend: numpy, kernel (the CUDA "
                         "scans, KB resident on the device), int8 (numpy over "
                         "the int8 KB) or int8-kernel (the CUDA int8 scans)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the model's random parameters")
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
    # the reference's flags for parts that are later slices: accepted so the
    # two CLIs take the same command lines, refused below when used
    ap.add_argument("--mesh-shards", type=int, default=0,
                    help="shard count of the sharded backends (not ported yet)")
    ap.add_argument("--inject-faults", default="",
                    help="seeded fault schedule for the KB path (the injection "
                         "harness is not ported yet)")
    for flag, kind in (("--arrival-rate", float), ("--arrival-trace", str),
                       ("--max-queue-depth", int), ("--queue-deadline", float)):
        ap.add_argument(flag, type=kind, default=kind(),
                        help="continuous scheduler only (not ported yet)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--full-width", action="store_true",
                    help="serve the model exactly as published (24 layers, "
                         "d_model 1024, vocab 50257) instead of the reduced "
                         "2-layer stack")
    args = ap.parse_args()
    try:
        validate_stack(args.workload, args.retriever, args.retriever_backend,
                       args.scheduler)
        device = resolve_device(args.device)
    except (ValueError, RuntimeError) as e:
        ap.error(str(e))
    if args.mesh_shards or args.inject_faults:
        ap.error("--mesh-shards and --inject-faults need the sharded backends "
                 "and the fault-injection harness, which are not ported yet")

    rcfg = variant_config(args.variant.replace("-", ""),
                          RaLMConfig(max_new_tokens=args.max_new,
                                     speculation_stride=args.stride,
                                     retry_max=args.retry_max,
                                     retry_backoff_s=args.retry_backoff,
                                     retrieval_timeout_s=args.retrieval_timeout))
    shared = (SharedRetrievalCache(capacity=args.shared_cache_capacity)
              if args.shared_cache else None)
    stack = build_stack(args.retriever, n_docs=args.n_docs,
                        backend=args.retriever_backend, seed=args.seed,
                        enc_dim=args.enc_dim, rcfg=rcfg, shared_cache=shared,
                        device=device, full_width=args.full_width)
    print(f"device {device} ({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'host'}), "
          f"model {stack.cfg.name}: {stack.cfg.num_layers} layers, "
          f"d_model {stack.cfg.d_model}, vocab {stack.cfg.vocab_size}; "
          f"{stack.retriever.name} backend {stack.retriever.backend.name}, "
          f"KB {len(stack.docs)} x {args.enc_dim}")
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
        print(f"{label:14s} wall {tot_w:7.2f}s  modeled {tot_an:6.2f}s  "
              f"throughput {n_tok / max(tot_an, 1e-9):8.1f} tok/s (modeled)")
        return tot_w, toks

    results = {}
    if args.mode in ("seq", "both"):
        results["seq"] = run(make_server(stack, scheduler="seq"), "RaLMSeq")
    if args.mode in ("spec", "both"):
        label = "RaLMSpec" + ("+" + args.variant.upper() if args.variant else "")
        if args.concurrency > 1:
            results["spec"] = run_fleet(f"Fleet x{args.concurrency}")
        else:
            results["spec"] = run(make_server(stack, scheduler="single"), label)
    if len(results) == 2:
        same = all(a == b for a, b in zip(results["seq"][1], results["spec"][1]))
        print(f"outputs identical: {same}   "
              f"speed-up {results['seq'][0] / max(results['spec'][0], 1e-9):.2f}x")
    if shared is not None:
        st = shared.stats()
        print(f"shared cache: {st['hits_exact']} exact + "
              f"{st['hits_approx']} approx hits / {st['lookups']} lookups "
              f"({st['hit_rate']:.0%} hit rate), {st['size']} entries")


if __name__ == "__main__":
    main()
