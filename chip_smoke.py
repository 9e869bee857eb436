#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. device: the card's name, its power limit (nvidia-smi), torch and CUDA;
2. build: compiles the three CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, in parallel);
3. kernels: each kernel against its plain PyTorch version on the card, at the
   main path's shapes, timed with CUDA events (median of repeated windows),
   beside its bound and one library call as a yardstick;
4. serving: full-width ralm-gpt2-medium (random weights from a seed) over a
   500k x 768 EDR KB through ``build_stack(..., backend="kernel")``: RaLMSeq,
   then a 4-slot FleetServer (variant psa); checks that the tokens are identical and that
   every kernel was launched on that path;
5. one JSON line with every kernel's numbers, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Any failed phase raises, so the exit code is not 0. Without a CUDA device it
exits with code 2 before printing any result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12         # H100 SXM fp32, CUDA cores (NVIDIA data sheet)
SERVE_N_DOCS = 500_000          # DPR's Wikipedia has 21M passages of d = 768
SERVE_ENC_DIM = 768


def check(ok, what: str) -> None:
    """A failed check ends the run with a non-zero exit code."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def bound_ms(nbytes: float, flops: float):
    t_b, t_f = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def cuda_ms(fn, windows: int = 11, inner: int = 5, warmup: int = 3) -> float:
    """Median over ``windows`` of the mean time of ``inner`` back-to-back
    calls, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def unit_rows(gen, n, d, dev):
    x = torch.randn((n, d), generator=gen, device=dev)
    return x / x.norm(dim=1, keepdim=True)


def grid_rows(rng, n, d, dev):
    """Entries in multiples of 1/2: every dot product is exact in fp32."""
    return torch.as_tensor(rng.integers(-2, 3, size=(n, d)).astype(np.float32) / 2,
                           device=dev)


# ---------------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------------
def check_dense_topk(dev, N: int, d: int, report: dict) -> None:
    from repro_torch.kernels import dense_topk as K
    from repro_torch.retrieval.backends import FlatBackend, TorchKernelBackend
    gen = torch.Generator(device=dev).manual_seed(1)
    kb = unit_rows(gen, N, d, dev)
    for B in (1, 12, 64):
        q = unit_rows(gen, B, d, dev)
        for k in (1, 20, 256):
            s_k, i_k = K.dense_topk(q, kb, k)
            s_p, i_p = K.dense_topk_plain(q, kb, k + 1)
            torch.cuda.synchronize()
            err = (s_k - s_p[:, :k]).abs().max().item()
            check(err <= 1e-5, f"B1 B={B} k={k}: |dscore| {err}")
            # where the k-th and (k+1)-th plain scores differ by more than 1e-5
            # the sets must agree; inside the set, ids may only trade places
            # with a neighbour whose plain score is within 1e-5
            gap = (s_p[:, k - 1] - s_p[:, k]) > 1e-5
            near = torch.zeros_like(i_k, dtype=torch.bool)
            sp = s_p[:, :k]
            near[:, 1:] |= (sp[:, :-1] - sp[:, 1:]) <= 1e-5
            near[:, :-1] |= (sp[:, :-1] - sp[:, 1:]) <= 1e-5
            bad = (i_k != i_p[:, :k]) & ~near
            check(not bad[gap].any(), f"B1 B={B} k={k}: ids differ")
            same_set = torch.sort(i_k, 1).values == torch.sort(i_p[:, :k], 1).values
            check(same_set[gap].all(), f"B1 B={B} k={k}: id sets differ")
            ms = cuda_ms(lambda: K.dense_topk(q, kb, k))
            plain = cuda_ms(lambda: K.dense_topk_plain(q, kb, k))
            lib = cuda_ms(lambda: torch.topk(q @ kb.T, k))
            bms, by = bound_ms(4.0 * (N * d + B * d + 2 * B * k), 2.0 * B * N * d)
            print(f"B1 dense_topk N={N} d={d} B={B:3d} k={k:3d}: kernel {ms:.4f} ms  "
                  f"plain {plain:.4f} ms  torch.topk(q@kb.T) {lib:.4f} ms  "
                  f"bound {bms:.4f} ms ({by})  max|dscore| {err:.2e}  "
                  f"rows with a clear k-th gap {int(gap.sum())}/{B}")
            if (B, k) == (12, 20):        # the fleet's merged psa call
                report["dense_topk"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                            bound_ms=bms, bound_by=by, library_ms=lib,
                                            shape=f"B={B} N={N} d={d} k={k}")
    # tie-heavy grid KB, N a multiple of no tile: byte-identical, batch-invariant
    rng = np.random.default_rng(3)
    base = grid_rows(rng, 375, 64, dev)
    gkb = base.repeat(8, 1)[:3001].contiguous()
    qs = grid_rows(rng, 12, 64, dev)
    for k in (1, 20, 256):
        s12, i12 = K.dense_topk(qs, gkb, k)
        s1, i1 = K.dense_topk(qs[:1].contiguous(), gkb, k)
        sp, ip = K.dense_topk_plain(qs, gkb, k)
        check(torch.equal(s12, sp) and torch.equal(i12, ip), f"B1 grid k={k}")
        check(torch.equal(s1, s12[:1]) and torch.equal(i1, i12[:1]), f"B1 B=1 vs 12 k={k}")
    small = grid_rows(rng, 100, 16, dev).cpu().numpy()
    qn = grid_rows(rng, 3, 16, dev).cpu().numpy()
    fi, fs = FlatBackend(small).search(qn, 256)
    ki, ks = TorchKernelBackend(small, device=dev).search(qn, 256)
    check(fi.shape == (3, 100) and np.array_equal(fi, ki) and np.array_equal(fs, ks),
          "B1 backend k=256 > N=100 differs from numpy")
    print("B1 grid KB N=3001 d=64 (tie-heavy), k in {1, 20, 256}: kernel == plain "
          "byte for byte, B=1 rows == B=12 rows; backend k=256 > N=100 == numpy")


def check_decode_attention(dev, report: dict) -> None:
    from repro_torch.kernels import decode_attention as K
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(2)
    B, W, hd = 4, 512, 64
    lens = torch.tensor([1, 97, 300, 512], dtype=torch.int32, device=dev)
    for H, KV in ((16, 16), (16, 4)):
        q = torch.randn((B, H, hd), generator=gen, device=dev)
        kc = torch.randn((B, W, KV, hd), generator=gen, device=dev)
        vc = torch.randn((B, W, KV, hd), generator=gen, device=dev)
        out = K.decode_attention(q, kc, vc, lens)
        ref = K.decode_attention_plain(q, kc, vc, lens)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        check(err <= 2e-5, f"B2 H={H} KV={KV}: max abs err {err}")
        ms = cuda_ms(lambda: K.decode_attention(q, kc, vc, lens))
        plain = cuda_ms(lambda: K.decode_attention_plain(q, kc, vc, lens))
        qs = q[:, :, None]
        ks = kc.permute(0, 2, 1, 3).repeat_interleave(H // KV, 1).contiguous()
        vs = vc.permute(0, 2, 1, 3).repeat_interleave(H // KV, 1).contiguous()
        mask = (torch.arange(W, device=dev)[None] < lens[:, None])[:, None, None]
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask))
        n = int(lens.clamp(max=W).sum())
        bms, by = bound_ms(4.0 * (2 * B * H * hd + 2 * n * KV * hd + B),
                           4.0 * n * H * hd)
        print(f"B2 decode_attention B={B} H={H} KV={KV} hd={hd} W={W} "
              f"cache_len={lens.tolist()}: kernel {ms:.4f} ms  plain {plain:.4f} ms  "
              f"SDPA {lib:.4f} ms  bound {bms:.5f} ms ({by})  max abs err {err:.2e}")
        if KV == H:
            report["decode_attention"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                              bound_ms=bms, bound_by=by, library_ms=lib,
                                              shape=f"B={B} H=KV={H} hd={hd} W={W} "
                                                    f"cache_len={lens.tolist()}")


def check_prefill_attention(dev, report: dict) -> None:
    from repro_torch.kernels import prefill_attention as K
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(3)
    hd = 64
    cases = [(112, 16, 16, 0, 0), (160, 16, 16, 0, 0), (300, 16, 16, 0, 0),
             (300, 16, 16, 64, 0), (200, 16, 16, 0, 37), (160, 16, 4, 0, 0)]
    for S, H, KV, window, prefix in cases:
        q = torch.randn((1, S, H, hd), generator=gen, device=dev)
        k = torch.randn((1, S, KV, hd), generator=gen, device=dev)
        v = torch.randn((1, S, KV, hd), generator=gen, device=dev)
        kw = dict(causal=True, window=window, prefix_len=prefix)
        out = K.prefill_attention(q, k, v, **kw)
        ref = K.prefill_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        check(err <= 2e-5, f"B3 S={S} H={H} KV={KV} w={window} p={prefix}: {err}")
        ms = cuda_ms(lambda: K.prefill_attention(q, k, v, **kw))
        plain = cuda_ms(lambda: K.prefill_attention_plain(q, k, v, **kw))
        lib = None
        if window == 0 and prefix == 0 and H == KV:
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
        pairs = int(K.allowed_mask(S, S, device=dev, **kw).sum())
        bms, by = bound_ms(4.0 * S * (2 * H + 2 * KV) * hd, 4.0 * pairs * H * hd)
        print(f"B3 prefill_attention S={S} H={H} KV={KV} hd={hd} causal window={window} "
              f"prefix={prefix}: kernel {ms:.4f} ms  plain {plain:.4f} ms  SDPA "
              f"{'n/a' if lib is None else f'{lib:.4f} ms'}  bound {bms:.5f} ms ({by})  "
              f"max abs err {err:.2e}")
        if (S, H, KV, window, prefix) == (160, 16, 16, 0, 0):
            report["prefill_attention"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                               bound_ms=bms, bound_by=by, library_ms=lib,
                                               shape=f"B=1 S={S} H=KV={H} hd={hd} causal")


# ---------------------------------------------------------------------------------
# phase 4: the port's main path at full width
# ---------------------------------------------------------------------------------
def serve_full_width(dev) -> dict:
    from repro_torch.configs import RaLMConfig
    from repro_torch.kernels import decode_attention, dense_topk, prefill_attention
    from repro_torch.launch.serve import build_stack, make_server, variant_config
    from repro_torch.serving.batched import BatchedServeEngine, _tree_map
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.training.data import make_queries

    t0 = time.perf_counter()
    rcfg = variant_config("psa", RaLMConfig(max_new_tokens=48))
    stack = build_stack("edr", backend="kernel", device=dev, full_width=True,
                        n_docs=SERVE_N_DOCS, enc_dim=SERVE_ENC_DIM, rcfg=rcfg)
    cfg = stack.cfg
    check((cfg.num_layers, cfg.d_model, cfg.vocab_size) == (24, 1024, 50257),
          "the serving stack is not full width")
    print(f"serving stack: {cfg.name} {cfg.num_layers} layers d_model {cfg.d_model} "
          f"heads {cfg.num_heads}/{cfg.num_kv_heads} d_ff {cfg.d_ff} vocab "
          f"{cfg.vocab_size}; EDR KB {stack.retriever.kb.embeddings.shape} on the card "
          f"({stack.retriever.backend.kb_bytes / 1e9:.2f} GB); built in "
          f"{time.perf_counter() - t0:.1f} s")
    prompts = [(q * 12)[:48] for q in make_queries(stack.docs, 8)]
    mods = (dense_topk, decode_attention, prefill_attention)
    for m in mods:
        m.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    seq = make_server(stack, scheduler="seq")
    t = time.perf_counter()
    seq_res = [seq.serve(p) for p in prompts]
    seq_wall = time.perf_counter() - t
    n_tok = sum(len(r.tokens) for r in seq_res)
    print(f"RaLMSeq   x8: wall {seq_wall:.3f} s  G {sum(r.gen_time for r in seq_res):.3f} s  "
          f"R {sum(r.retrieval_time for r in seq_res):.3f} s  {n_tok / seq_wall:.1f} tok/s  "
          f"KB calls {sum(r.kb_calls for r in seq_res)}")
    fleet_res, fleet_wall, rounds, kb_calls = [], 0.0, 0, 0
    with make_server(stack, scheduler="fixed", n_slots=4) as fleet:
        for i in range(0, len(prompts), 4):
            fr = fleet.serve(prompts[i:i + 4])
            check(fr.kb_errors == 0 and fr.degraded_rounds == 0 and fr.worker_crashes == 0,
                  "a fleet KB call failed")
            fleet_res += fr.results
            fleet_wall += fr.wall_time
            rounds += fr.rounds
            kb_calls += fr.kb_calls
    g = sum(r.gen_time for r in fleet_res[::4])       # one fleet-wide ledger per group
    r_t = sum(r.retrieval_time for r in fleet_res[::4])
    print(f"Fleet x4 psa x8: wall {fleet_wall:.3f} s  G {g:.3f} s  R {r_t:.3f} s  "
          f"{n_tok / fleet_wall:.1f} tok/s  rounds {rounds}  KB calls {kb_calls}  "
          f"speed-up over RaLMSeq {seq_wall / fleet_wall:.2f}x")
    counts = {m.__name__.rsplit(".", 1)[1]: m.launches for m in mods}
    peak = torch.cuda.max_memory_allocated() / 2**30
    same = [a.tokens == b.tokens for a, b in zip(seq_res, fleet_res)]
    print(f"serving: launches {counts}  peak device memory {peak:.2f} GiB  "
          f"outputs identical: {all(same)}")
    check(all(same), f"fleet tokens differ from RaLMSeq: {same}")
    check(all(len(r.tokens) == 48 for r in seq_res), "RaLMSeq stopped short of 48 tokens")
    check(all(v > 0 for v in counts.values()), f"a kernel was not launched: {counts}")

    # batch variance: one slot of a batched decode step vs the same context alone
    docs = [tuple(stack.docs[i][:64]) for i in range(4)]
    beng = BatchedServeEngine(stack.model, stack.params, 4, cache_window=512)
    singles = [ServeEngine(stack.model, stack.params, cache_window=512) for _ in range(4)]
    for b in range(4):
        beng.start(b, prompts[b], docs[b])
        singles[b].start(prompts[b], docs[b])
    dmax = 0.0
    for _ in range(16):
        beng.gen(list(range(4)), [1] * 4)
        for b in range(4):
            singles[b].gen(1)
            check(singles[b].tokens == beng.tokens[b], f"slot {b}: B=4 and B=1 tokens differ")
            dmax = max(dmax, (beng._last_logits[b] - singles[b]._last_logits[0])
                       .abs().max().item())
    print(f"batch variance: max |dlogit| between a slot of a B=4 decode step and the "
          f"same context decoded at B=1, over 16 steps: {dmax:.3e}")

    # the cost of functional snapshots: every decode step copies the bundle
    state, pos = beng._state, beng._pos
    nbytes = sum(t.numel() * t.element_size() for st in state for t in st.values())
    copy = cuda_ms(lambda: _tree_map(lambda c: c.clone(), state), windows=5, inner=3)
    tok = torch.zeros((4,), dtype=torch.long, device=dev)
    with torch.no_grad():
        step = cuda_ms(lambda: stack.model.decode_step(stack.params, state, tok, pos),
                       windows=5, inner=3)
    print(f"snapshot copy: the B=4 W=512 decode state is {nbytes / 1e6:.1f} MB; copying it "
          f"takes {copy:.4f} ms; one full-width B=4 decode step takes {step:.4f} ms")

    # where a decode step and a re-prefill spend their time on the device
    toks = torch.as_tensor([list(docs[0]) + prompts[0][:96]], device=dev)   # S = 160
    work = {"B=4 decode step": (lambda: stack.model.decode_step(
                stack.params, state, tok, pos), step),
            "B=1 re-prefill S=160": (lambda: stack.model.prefill(
                stack.params, toks, window_cache=512), None)}
    for label, (fn, ms) in work.items():
        with torch.no_grad():
            if ms is None:
                ms = cuda_ms(fn, windows=5, inner=3)
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
        ev = prof.key_averages()
        dev_us = [(e.key, e.self_device_time_total) for e in ev
                  if e.device_type == torch.autograd.DeviceType.CUDA]   # kernels, copies
        busy = sum(t for _, t in dev_us) / 3e3
        top = ", ".join(f"{k[:40]} {t / 3e3:.3f}" for k, t in
                        sorted(dev_us, key=lambda x: -x[1])[:5])
        print(f"profile {label}: {ms:.4f} ms per call (CUDA events), device busy "
              f"{busy:.4f} ms ({busy / ms:.1%}), idle {1 - busy / ms:.1%}; top device "
              f"time per call (ms): {top}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    import repro_torch  # noqa: F401  (switches TF32 off)
    from repro_torch.kernels import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | torch "
          f"{torch.__version__} CUDA {torch.version.cuda} | tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}/{torch.backends.cudnn.allow_tf32}")
    t = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {len(logs)} kernels in {time.perf_counter() - t:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    report: dict = {}
    check_dense_topk(dev, SERVE_N_DOCS, SERVE_ENC_DIM, report)
    check_decode_attention(dev, report)
    check_prefill_attention(dev, report)
    counts = serve_full_width(dev)

    sources = {"dense_topk": ("src/repro_torch/kernels/csrc/dense_topk.cu",
                              "src/repro/kernels/dense_topk.py:188"),
               "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:66"),
               "prefill_attention": ("src/repro_torch/kernels/csrc/prefill_attention.cu",
                                     "src/repro/kernels/prefill_attention.py:90")}
    kernels = []
    for name, (src, replaces) in sources.items():
        r = report[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "shape": r["shape"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
