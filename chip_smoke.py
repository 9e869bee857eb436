#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase below
    python3 chip_smoke.py --src DIR        # phases 1-3 only, for the src/ tree DIR
    python3 chip_smoke.py --walls [--src DIR]  # phase 4's EDR kernel path, phase
                                           # 5's knnlm-247m steps and one MoE
                                           # family path (two trees compared)
    python3 chip_smoke.py --across-cards   # the sharded backends with a shard on
                                           # every card (more than one card)

1. device: the card's name, its power limit (nvidia-smi), torch and CUDA;
2. build: compiles the four CUDA sources from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, in parallel);
3. kernels: each of the eight kernels (B1-B8) against its plain PyTorch
   version on the card, at the main paths' shapes (the gathered scans over
   the candidate matrix of the ADR index from real queries, B6 over the int8
   codes of the serving KB) and on tie-heavy grid KBs, the scans at k = 1,
   20, 256 and 300 (above 256: the key pass and the select pass); B1's rows
   at B=1 and B=12 against its B=64 rows on the serving KB, B3 at its tile
   edges; both kernel backends at d = 6 and 50 against the numpy backends
   (any d: ROADMAP fault C1); B2 at the fleet's B=4 and RaLMSeq's B=1
   shapes (warm and cold L2), a slot's B=1 row == its B=4 row byte for
   byte, and 12 query heads per KV head at hd 128 with cache_len 0 and > W
   (ROADMAP fault C2); B2 and B3 at hd 256 (paligemma-3b's 8 / 1 heads,
   timed), 112 and 32, at cache_len 0 and past W, causal, windowed and with
   a prefix (ROADMAP fault C3), and at hd 264, 384 and 512 through the
   wide-head kernels (timed at hd 512 against SDPA, its backend named: B2
   at the fleet's B=4, RaLMSeq's B=1 and 8 query heads a KV head, B3 at
   S=160 causal; B2 also at W = 16,384, 64 chunks merged); B3
   bidirectional at whisper-base's encoder shape (S = 1500, 8 / 8 heads at
   hd 64), timed; the sharded backends against the unsharded kernel
   backends byte for byte on the serving KB (``sharded`` == ``kernel``,
   ``int8-sharded`` == ``int8-kernel``, S in {2, 3, 4}, B in {1, 4, 12}, k
   in {1, 20, 300}, search and search_gathered over the ADR candidates), one
   scan launch a shard, and one 4-shard search timed beside the unsharded
   B1 at B = 4 and 12. A tree run with --src that refuses k > 256,
   such d, such heads or such head dims is checked without those shapes. Each
   kernel and one library call as its yardstick get two times: the device
   time (20 calls captured in a CUDA graph, the replay timed with CUDA
   events) and the per-call time (CUDA events around 5 back-to-back calls,
   host dispatch included), beside the bound. ``--src DIR`` runs phases 1-3
   with the kernels of another tree (e.g. an unpacked parent commit) and
   stops, so that two trees are checked and timed by the same code at the
   same shapes on one card;
4. serving: full-width ralm-gpt2-medium (random weights from a seed) over a
   500k x 768 KB: EDR through ``build_stack(..., backend="kernel")``, then ADR
   on the same model and KB (one kernel backend holds the fp32 KB for both),
   then EDR and ADR on the ``int8-kernel`` backend; each path serves RaLMSeq,
   then a 4-slot FleetServer (variant psa), checks that the tokens are
   identical and that the path's kernels were launched on it (counts set to 0
   just before the path and read just after); recall@20 of int8 against fp32
   over the queries the int8 paths served. Then the sharded backends as
   ``--mesh-shards 4`` builds them, the KB in 4 shards on the card: EDR
   over ``sharded`` (8 prompts), ADR over it, EDR and ADR over
   ``int8-sharded`` (4 prompts each), each path's tokens equal to its
   unsharded backend's path's, one backend call a search and, on EDR, one
   scan launch a shard a call (the backends freed after). Then the EDR fleet with seeded
   faults injected into its KB path (RaLMSeq's tokens, no round degraded);
   SR (BM25 over a 50k-passage SparseKB, RaLMSeq and the fleet); and KNN-LM:
   full-width knnlm-247m over a 1M x 1024 datastore, KNNLMSeq against the
   4-slot fleet on EDR (B1) and ADR (B4, the IVF index built on the host
   over the same datastore), and ContinuousFleetServer over Poisson
   arrivals; B1 at the datastore's shape (N = 1M, d = 1024, k = 8) at
   B = 1 and at the largest merged B the KNN-LM fleet issued, checked and
   timed as in phase 3. Then, with the gpt2 weights and the KNN-LM stack
   freed, three more model families at full width, each through
   ``build_stack(arch=..., full_width=True)`` over the same 500k KB,
   RaLMSeq against the 4-slot fleet on 4 prompts: qwen2-moe-a2.7b (MoE, 60
   experts, B1-B3), xlstm-350m (mLSTM and sLSTM, no attention: B1),
   paligemma-3b (B1, and B2 and B3 at hd 256) and whisper-base (6 encoder
   and 6 decoder layers, its engines handing (1, 1500, 512) frames from
   numpy seed 0 to every prefill: B1, B2, and B3 in the decoder and
   bidirectionally in the encoder), each with its peak device memory and
   one timed re-prefill (whisper's encoder share apart); then phase 5;
   last, the engine checks (batch variance, snapshot cost, a profiled
   decode step and re-prefill) on the gpt2 weights drawn again from their
   seed;
5. training: one train step at ``reduced()`` size for a dense, a MoE
   (capacity dispatch), an SSM, a VLM and an audio config, on the card and
   on the CPU from the same parameters and batch (loss, aux, grad norm and
   updated parameters agree); B3 and B2 refuse CUDA inputs that require
   grad. Then knnlm-247m as published (16 layers, d_model 1024, 247M
   parameters) trained through ``launch.train.train`` for 50 steps of
   SyntheticLM 8 x 128 with AdamW: the loss must fall; ms a step (CUDA
   events), tokens/s, peak device memory, the attention core's share of a
   step and the step's parts (forward, backward, AdamW) timed alone; the
   eval loss through B3 against the differentiable route
   (1e-5 relative), ``forward(last_only=True)`` through B3, a 2-microbatch
   step against the 1-microbatch step, and a checkpoint saved and restored
   byte for byte. The train steps launch no kernel; the eval pass and the
   last_only forward launch B3 (counted with the serving paths' launches);
6. the dry-run group (after phase 5, before the engine checks): the
   1 x 1-mesh dry-run of llama3.2-1b x long_500k (fp32) gives the
   arguments' bytes, which must be within 1% of the allocator's delta for
   the same params (as published, seed 0 on the card), stacked decode state
   (B = 1, W = 16,384) and token; 8 greedy steps of ``decode_step_stacked``
   from pos 524,287 (every row's cache_len W) against ``decode_step`` on
   the same state (logits within 1e-5, tokens identical, B2 launched once
   a layer and step on each), with each path's ms a step (CUDA events) and
   peak memory; ``lower_sharded_retrieval(4)``'s search over 8 queries
   (1,048,576 x 256, k = 20) byte-equal to the unsharded B1, one launch a
   shard; then B2 at that shape (B 1, H 32 / KV 8, hd 64, W 16,384: 256
   chunks a row) against its plain version and SDPA, timed as in phase 3.
   Then the same stacked step with params, state and token as DTensors on
   the 1 x 1 CUDA mesh (B2 on each rank's shards through ``local_map``):
   its logits against the plain stacked step's over the 8 steps (within
   1e-5), B2 once a layer and step, a collective census that is all zero,
   and its ms a step (DTensor's host dispatch); and the 1 x 1 record's
   argument + temp + output bytes within 10% of the allocator's peak over
   one plain stacked step from the same state, the arguments included.
   The decode and search launches count with the serving paths';
7. one JSON line with phase 6's numbers and one with every kernel's, the
   script's total seconds, the nvidia-smi line, and last ``{"ok": true,
   "device": {...}}``.

Any failed phase raises, so the exit code is not 0. Without a CUDA device it
exits with code 2 before printing any result.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import gc
import importlib.util
import itertools
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12         # H100 SXM fp32, CUDA cores (NVIDIA data sheet)
SERVE_N_DOCS = 500_000          # DPR's Wikipedia has 21M passages of d = 768
SERVE_ENC_DIM = 768
SR_N_DOCS = 50_000              # BM25 scores every passage on the host per query
KNN_N_DOCS = 20_834             # 48 tokens each: a 1,000,032-token stream
KNN_ENTRIES = 1_000_000         # Wikitext-103's datastore holds 103M entries
KNN_KEY_DIM = 1024              # knnlm-247m's d_model: the width of its keys
KNN_ARRIVAL_RATE = 8.0          # requests per modeled second: 8 arrive in ~0.7 s
T0 = 0.0                        # when main() started


def takes_any_d_and_k() -> bool:
    """Whether the kernels of the tree under test take any d and k > 256
    (an older tree, run with --src, refuses them: those shapes are skipped)."""
    from repro_torch.kernels import dense_topk
    return hasattr(dense_topk, "pad_d")


def scan_ks() -> tuple:
    """The k of the scan checks: the serving k (1, prefetch 20), the lists'
    largest (256) and one above it (300: the key pass and the select pass)."""
    return (1, 20, 256, 300) if takes_any_d_and_k() else (1, 20, 256)


def check(ok, what: str) -> None:
    """A failed check ends the run with a non-zero exit code."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def bound_ms(nbytes: float, flops: float):
    t_b, t_f = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def cuda_ms(fn, windows: int = 11, inner: int = 5, warmup: int = 3) -> float:
    """Per-call time: median over ``windows`` of the mean time of ``inner``
    back-to-back calls, from CUDA events. Where the host takes longer to
    issue a call than the device to run it, this is host time."""
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


def device_ms(fn, launches: int = 20, reps: int = 7) -> float:
    """Device time per call: ``launches`` calls captured in one CUDA graph,
    the graph replayed ``reps`` times between CUDA events, the median replay
    divided by ``launches``. Host dispatch is paid once, at capture, so this
    is the kernels' own time plus the gaps between them on the device. No
    profiler is involved. The wrappers' launch counts are restored after:
    capture and replay do not launch through the wrappers."""
    saved = read_counts()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):            # warm up (cuBLAS workspaces) off the capture
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    # relaxed: an older tree (--src) may make runtime calls inside a launch
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    del graph
    set_counts(saved)
    return statistics.median(times)


def timed(kernel, library) -> dict:
    """A kernel wrapper's and its library call's device and per-call times."""
    return dict(device_ms=device_ms(kernel), call_ms=cuda_ms(kernel),
                library_device_ms=None if library is None else device_ms(library),
                library_call_ms=None if library is None else cuda_ms(library))


def fmt_times(t: dict, lib_name: str) -> str:
    lib = ("n/a" if t["library_device_ms"] is None else
           f"{t['library_device_ms']:.4f} ms device, {t['library_call_ms']:.4f} ms per call")
    return (f"kernel {t['device_ms']:.4f} ms device, {t['call_ms']:.4f} ms per call  "
            f"{lib_name} {lib}")


def unit_rows(gen, n, d, dev):
    x = torch.randn((n, d), generator=gen, device=dev)
    return x / x.norm(dim=1, keepdim=True)


def grid_rows(rng, n, d, dev):
    """Entries in multiples of 1/2: every dot product is exact in fp32."""
    return torch.as_tensor(rng.integers(-2, 3, size=(n, d)).astype(np.float32) / 2,
                           device=dev)


def compare_topk(tag: str, s_k, i_k, s_p, i_p, k: int):
    """A kernel's top k against its plain version's top k + 1, where the
    summation orders differ: scores within 1e-5; where the k-th and
    (k+1)-th plain scores differ by more than 1e-5 the id sets agree, and
    inside the set ids only trade places with a neighbour whose plain score
    is within 1e-5. Returns (max |dscore|, rows with a clear k-th gap)."""
    torch.cuda.synchronize()
    err = (s_k - s_p[:, :k]).abs().max().item()
    check(err <= 1e-5, f"{tag}: |dscore| {err}")
    gap = (s_p[:, k - 1] - s_p[:, k]) > 1e-5
    near = torch.zeros_like(i_k, dtype=torch.bool)
    sp = s_p[:, :k]
    near[:, 1:] |= (sp[:, :-1] - sp[:, 1:]) <= 1e-5
    near[:, :-1] |= (sp[:, :-1] - sp[:, 1:]) <= 1e-5
    bad = (i_k != i_p[:, :k]) & ~near
    check(not bad[gap].any(), f"{tag}: ids differ")
    same_set = torch.sort(i_k, 1).values == torch.sort(i_p[:, :k], 1).values
    check(same_set[gap].all(), f"{tag}: id sets differ")
    return err, gap


# ---------------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------------
def check_dense_topk(dev, N: int, d: int, report: dict) -> None:
    from repro_torch.kernels import dense_topk as K
    from repro_torch.retrieval.backends import FlatBackend, TorchKernelBackend
    gen = torch.Generator(device=dev).manual_seed(1)
    kb = unit_rows(gen, N, d, dev)
    q64 = unit_rows(gen, 64, d, dev)
    for k in scan_ks():
        rows = {}
        for B in (1, 12, 64):
            q = q64[:B]
            s_k, i_k = rows[B] = K.dense_topk(q, kb, k)
            s_p, i_p = K.dense_topk_plain(q, kb, k + 1)
            err, gap = compare_topk(f"B1 B={B} k={k}", s_k, i_k, s_p, i_p, k)
            t = timed(lambda: K.dense_topk(q, kb, k), lambda: torch.topk(q @ kb.T, k))
            plain = cuda_ms(lambda: K.dense_topk_plain(q, kb, k))
            bms, by = bound_ms(4.0 * (N * d + B * d + 2 * B * k), 2.0 * B * N * d)
            print(f"B1 dense_topk N={N} d={d} B={B:3d} k={k:3d}: "
                  f"{fmt_times(t, 'torch.topk(q@kb.T)')}  plain {plain:.4f} ms  "
                  f"bound {bms:.4f} ms ({by})  max|dscore| {err:.2e}  "
                  f"rows with a clear k-th gap {int(gap.sum())}/{B}")
            if (B, k) == (12, 20):        # the fleet's merged psa call
                report["dense_topk"] = dict(max_abs_err=err, plain_ms=plain, bound_ms=bms,
                                            bound_by=by, shape=f"B={B} N={N} d={d} k={k}", **t)
        # a query's row does not depend on the batch it comes in
        s64, i64 = rows[64]
        for B in (1, 12):
            check(torch.equal(rows[B][0], s64[:B]) and torch.equal(rows[B][1], i64[:B]),
                  f"B1 unit KB k={k}: B={B} rows != B=64 rows")
    print(f"B1 unit KB N={N} d={d}, k in {set(scan_ks())}: B=1 and B=12 rows == B=64 rows "
          f"byte for byte")
    # tie-heavy grid KB, N a multiple of no tile: byte-identical, batch-invariant
    rng = np.random.default_rng(3)
    base = grid_rows(rng, 375, 64, dev)
    gkb = base.repeat(9, 1)[:3001].contiguous()
    qs = grid_rows(rng, 12, 64, dev)
    for k in scan_ks():
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
    print(f"B1 grid KB N=3001 d=64 (tie-heavy), k in {set(scan_ks())}: kernel == plain "
          f"byte for byte, B=1 rows == B=12 rows; backend k=256 > N=100 == numpy")


def takes_any_group() -> bool:
    """Whether B2 of the tree under test takes any H / KV and answers
    cache_len 0 with the window's mean, as the reference does (ROADMAP fault
    C2; an older tree, run with --src, refuses H / KV > 8 and answers zeros:
    those checks are skipped)."""
    from repro_torch.kernels import decode_attention
    return not hasattr(decode_attention, "MAX_GROUP")


def decode_inputs(gen, B, W, H, KV, hd, dev):
    return (torch.randn((B, H, hd), generator=gen, device=dev),
            torch.randn((B, W, KV, hd), generator=gen, device=dev),
            torch.randn((B, W, KV, hd), generator=gen, device=dev))


def decode_bytes(lens, W: int, H: int, KV: int, hd: int) -> float:
    """The least bytes of one B2 call: q and out, the valid keys and values
    (a slot at cache_len <= 0 reads the window's values), the lengths."""
    n = int(lens.clamp(max=W).sum())
    n_mean = int((lens <= 0).sum()) * W
    B = lens.numel()
    return 4.0 * (2 * B * H * hd + (2 * n + n_mean) * KV * hd + B)


def sdpa_call(q, k, v, **kw):
    """SDPA on (B, H, S, hd) tensors under the first of its backends, in the
    dispatcher's order of preference, that takes these inputs (flash takes
    no hd above 256 and no mask) -> (the call, the backend's name), so that
    the time reported is the named backend's."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    F = torch.nn.functional
    order = [SDPBackend(i) for i in torch._C._get_sdp_priority_order()]
    for b in (b for b in order if b != SDPBackend.OVERRIDEABLE):
        def call(b=b):
            with sdpa_kernel([b]):
                return F.scaled_dot_product_attention(q, k, v, **kw)
        try:
            with warnings.catch_warnings():       # each refusal warns its reasons
                warnings.simplefilter("ignore")
                call()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return call, b.name.lower()
    raise RuntimeError("no SDPA backend takes these inputs")


def time_decode(K, q, kc, vc, lens, gen) -> dict:
    """B2 at one shape against its plain version (2e-5), its device and call
    times, SDPA's, the plain version's, and the bound; where a slot fills
    the window, also the device time with a cold L2: the captured calls
    rotate over enough distinct caches that the bytes read between two uses
    of one cache exceed the 50 MB L2 twice over (inputs that stay in L2
    across replays time the L2, not the HBM that a decode step of 24 layers
    reads from)."""
    F = torch.nn.functional
    B, H, hd = q.shape
    W, KV = kc.shape[1], kc.shape[2]
    out = K.decode_attention(q, kc, vc, lens)
    ref = K.decode_attention_plain(q, kc, vc, lens)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    check(err <= 2e-5, f"B2 B={B} H={H} KV={KV} hd={hd} lens={lens.tolist()}: {err}")
    plain = cuda_ms(lambda: K.decode_attention_plain(q, kc, vc, lens))
    qs = q[:, :, None]
    ks = kc.permute(0, 2, 1, 3).repeat_interleave(H // KV, 1).contiguous()
    vs = vc.permute(0, 2, 1, 3).repeat_interleave(H // KV, 1).contiguous()
    mask = (torch.arange(W, device=q.device)[None] < lens[:, None])[:, None, None]
    lib, backend = sdpa_call(qs, ks, vs, attn_mask=mask)
    t = timed(lambda: K.decode_attention(q, kc, vc, lens), lib)
    n = int(lens.clamp(max=W).sum())
    bms, by = bound_ms(decode_bytes(lens, W, H, KV, hd), 4.0 * n * H * hd)
    r = dict(max_abs_err=err, plain_ms=plain, bound_ms=bms, bound_by=by, sdpa_backend=backend,
             shape=f"B={B} H={H} KV={KV} hd={hd} W={W} cache_len={lens.tolist()}", **t)
    cold = ""
    if int(lens.max()) == W:
        per_call = decode_bytes(lens, W, H, KV, hd)
        sets = [decode_inputs(gen, B, W, H, KV, hd, q.device)[1:]
                for _ in range(int(np.ceil(100e6 / per_call)) + 1)]
        turn = itertools.cycle(sets)

        def rotating():
            k_, v_ = next(turn)
            return K.decode_attention(q, k_, v_, lens)
        r["cold_device_ms"] = device_ms(rotating, launches=max(20, len(sets)))
        r["cold_sets"] = len(sets)
        cold = f"  cold L2 {r['cold_device_ms']:.4f} ms device ({len(sets)} caches)"
    print(f"B2 decode_attention {r['shape']}: {fmt_times(t, f'SDPA ({backend})')}  plain "
          f"{plain:.4f} ms  bound {bms:.5f} ms ({by}, {bms / t['device_ms']:.1%} of the "
          f"device time)  max abs err {err:.2e}{cold}")
    return r


def check_decode_attention(dev, report: dict) -> None:
    """B2 at the fleet's B=4 shape and RaLMSeq's B=1 shapes (timed, warm and
    cold L2 at L=512), GQA rows, a slot's B=1 row == its B=4 row byte for
    byte, and (fault C2) 12 query heads per KV head at hd 128 with cache_len
    0 and > W."""
    from repro_torch.kernels import decode_attention as K
    gen = torch.Generator(device=dev).manual_seed(2)
    B, W, hd = 4, 512, 64
    lens = torch.tensor([1, 97, 300, 512], dtype=torch.int32, device=dev)
    for H, KV in ((16, 16), (16, 4)):
        q, kc, vc = decode_inputs(gen, B, W, H, KV, hd, dev)
        r = time_decode(K, q, kc, vc, lens, gen)
        if KV == H:
            report["decode_attention"] = r
            out = K.decode_attention(q, kc, vc, lens)
            for b, L in enumerate(lens.tolist()):     # RaLMSeq's B=1 at the same slots
                one = lens[b:b + 1].clone()           # 16-byte aligned
                check(torch.equal(K.decode_attention(q[b:b + 1], kc[b:b + 1], vc[b:b + 1],
                                                     one)[0], out[b]),
                      f"B2 L={L}: the B=1 row != the B=4 row")
                if L > 1:
                    report.setdefault("decode_attention@B=1", {})[f"L={L}"] = time_decode(
                        K, q[b:b + 1], kc[b:b + 1], vc[b:b + 1], one, gen)
            print(f"B2 H=KV={H} hd={hd} W={W}: each slot's B=1 row == its B=4 row byte "
                  f"for byte")
    if not takes_any_group():
        return
    # C2: 12 query heads per KV head at hd 128 (command-r-plus-104b's 96 / 8),
    # cache_len 0 (every entry masked: the mean of v over the window) and > W
    H, KV, hd = 96, 8, 128
    q, kc, vc = decode_inputs(gen, B, W, H, KV, hd, dev)
    time_decode(K, q, kc, vc, lens, gen)
    edge = torch.tensor([0, 63, 65, 600], dtype=torch.int32, device=dev)
    out = K.decode_attention(q, kc, vc, edge)
    err = (out - K.decode_attention_plain(q, kc, vc, edge)).abs().max().item()
    check(err <= 2e-5, f"B2 G=12 hd=128 lens={edge.tolist()}: max abs err {err}")
    mean = vc[0].mean(0).repeat_interleave(H // KV, 0)
    merr = (out[0] - mean).abs().max().item()
    check(merr <= 2e-5, f"B2 cache_len 0: max |out - mean of v| {merr}")
    print(f"B2 G=12 hd=128 W={W} cache_len={edge.tolist()}: max abs err {err:.2e}; the "
          f"cache_len 0 row is the window's mean of v within {merr:.2e}")


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
        plain = cuda_ms(lambda: K.prefill_attention_plain(q, k, v, **kw))
        lib = None
        if window == 0 and prefix == 0 and H == KV:
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)  # noqa: E731
        t = timed(lambda: K.prefill_attention(q, k, v, **kw), lib)
        pairs = int(K.allowed_mask(S, S, device=dev, **kw).sum())
        bms, by = bound_ms(4.0 * S * (2 * H + 2 * KV) * hd, 4.0 * pairs * H * hd)
        print(f"B3 prefill_attention S={S} H={H} KV={KV} hd={hd} causal window={window} "
              f"prefix={prefix}: {fmt_times(t, 'SDPA')}  plain {plain:.4f} ms  "
              f"bound {bms:.5f} ms ({by})  max abs err {err:.2e}")
        if (S, H, KV, window, prefix) == (160, 16, 16, 0, 0):
            report["prefill_attention"] = dict(max_abs_err=err, plain_ms=plain, bound_ms=bms,
                                               bound_by=by, shape=f"B=1 S={S} H=KV={H} "
                                                                  f"hd={hd} causal", **t)
    # the q-tile (16 rows) and k/v-tile edges, hd 64 and 128, at B=2: within
    # 2e-5 of the plain version, and each sequence's rows equal a B=1 call's
    edges = [(1, 16, 16, 64, True, 0, 0), (15, 16, 4, 64, True, 8, 0),
             (16, 16, 16, 128, True, 0, 5), (17, 16, 2, 64, True, 0, 0),
             (33, 8, 8, 128, True, 16, 0), (33, 8, 2, 64, False, 0, 0),
             (300, 16, 4, 128, True, 0, 37), (513, 16, 16, 64, True, 100, 0),
             (513, 8, 2, 128, True, 0, 0)]
    worst = 0.0
    for S, H, KV, hdx, causal, window, prefix in edges:
        q = torch.randn((2, S, H, hdx), generator=gen, device=dev)
        k = torch.randn((2, S, KV, hdx), generator=gen, device=dev)
        v = torch.randn((2, S, KV, hdx), generator=gen, device=dev)
        kw = dict(causal=causal, window=window, prefix_len=prefix)
        out = K.prefill_attention(q, k, v, **kw)
        err = (out - K.prefill_attention_plain(q, k, v, **kw)).abs().max().item()
        check(err <= 2e-5, f"B3 edge S={S} H={H} KV={KV} hd={hdx} {kw}: {err}")
        for b in range(2):
            one = K.prefill_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1], **kw)
            check(torch.equal(one[0], out[b]), f"B3 edge S={S} hd={hdx}: B=2 row {b} != B=1")
        worst = max(worst, err)
    print(f"B3 tile edges S in {{1, 15, 16, 17, 33, 300, 513}} (hd 64 and 128, window, prefix, "
          f"GQA, bidirectional) at B=2: max abs err {worst:.2e}, B=2 rows == B=1 calls")


def takes_any_head_dim() -> bool:
    """Whether B2 and B3 of the tree under test take every hd <= 256
    (ROADMAP fault C3; an older tree, run with --src, takes hd 64 and 128
    only: those checks are skipped)."""
    from repro_torch.kernels import decode_attention
    return hasattr(decode_attention, "instance_hd")


def time_prefill(K, q, k, v, kw: dict, label: str) -> dict:
    """B3 at one shape against its plain version (2e-5), its device and
    call times, SDPA's (on k and v expanded to every query head outside the
    timed call, where the mask is plain causal), the plain version's, and
    the bound."""
    F = torch.nn.functional
    _, S, H, hd = q.shape
    KV = k.shape[2]
    out = K.prefill_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    err = (out - K.prefill_attention_plain(q, k, v, **kw)).abs().max().item()
    check(err <= 2e-5, f"B3 {label}: max abs err {err}")
    plain = cuda_ms(lambda: K.prefill_attention_plain(q, k, v, **kw))
    lib, backend = None, None
    if kw["window"] == 0 and kw["prefix_len"] == 0:
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t.transpose(1, 2).repeat_interleave(H // KV, 1).contiguous() for t in (k, v))
        lib, backend = sdpa_call(qt, kt, vt, is_causal=kw["causal"])
    t = timed(lambda: K.prefill_attention(q, k, v, **kw), lib)
    pairs = int(K.allowed_mask(S, S, device=q.device, **kw).sum())
    bms, by = bound_ms(4.0 * S * (2 * H + 2 * KV) * hd, 4.0 * pairs * H * hd)
    print(f"B3 prefill_attention {label}: {fmt_times(t, f'SDPA ({backend})')}  plain "
          f"{plain:.4f} ms  bound {bms:.5f} ms ({by}, {bms / t['device_ms']:.1%} of the "
          f"device time)  max abs err {err:.2e}")
    return dict(max_abs_err=err, plain_ms=plain, bound_ms=bms, bound_by=by, shape=label,
                sdpa_backend=backend, **t)


def check_head_dims(dev, report: dict) -> None:
    """ROADMAP fault C3: B2 and B3 at the head dims of the configs the port
    serves beside hd 64 and 128. paligemma-3b's 8 query heads over 1 KV head
    at hd 256, timed: B2 at the fleet's B=4 and RaLMSeq's B=1, B3 at S=160
    causal; then, at hd 256, 112 (kimi-k2's 64 / 8 heads) and 32 (reduced
    configs), B2 at cache_len 0, 1, 63, 64, 65, W and past W with each
    slot's row equal to its B=1 call, and B3 causal, with a sliding window
    and with a bidirectional prefix, each within 2e-5 of the plain version."""
    from repro_torch.kernels import decode_attention as DK
    from repro_torch.kernels import prefill_attention as PK
    gen = torch.Generator(device=dev).manual_seed(7)
    W, S = 512, 160
    q, kc, vc = decode_inputs(gen, 4, W, 8, 1, 256, dev)
    lens = torch.tensor([1, 97, 300, 512], dtype=torch.int32, device=dev)
    report["decode_attention@hd256"] = {
        "B=4": time_decode(DK, q, kc, vc, lens, gen),
        "B=1 L=512": time_decode(DK, q[3:4], kc[3:4], vc[3:4], lens[3:4].clone(), gen)}
    q, k, v = (torch.randn((1, S, h, 256), generator=gen, device=dev) for h in (8, 1, 1))
    report["prefill_attention@hd256"] = time_prefill(
        PK, q, k, v, dict(causal=True, window=0, prefix_len=0),
        f"B=1 S={S} H=8 KV=1 hd=256 causal")
    edge = torch.tensor([0, 1, 63, 64, 65, W, W + 9], dtype=torch.int32, device=dev)
    worst = 0.0
    for hd, H, KV in ((256, 8, 1), (112, 64, 8), (32, 4, 2)):
        q, kc, vc = decode_inputs(gen, len(edge), W, H, KV, hd, dev)
        out = DK.decode_attention(q, kc, vc, edge)
        err = (out - DK.decode_attention_plain(q, kc, vc, edge)).abs().max().item()
        check(err <= 2e-5, f"B2 hd={hd} H={H} KV={KV} lens={edge.tolist()}: {err}")
        for b in range(len(edge)):
            one = DK.decode_attention(q[b:b + 1], kc[b:b + 1], vc[b:b + 1], edge[b:b + 1].clone())
            check(torch.equal(one[0], out[b]), f"B2 hd={hd}: slot {b}'s B=1 row != its row")
        worst = max(worst, err)
        for window, prefix in ((0, 0), (64, 0), (0, 37)):
            qq, kk, vv = (torch.randn((2, S, h, hd), generator=gen, device=dev)
                          for h in (H, KV, KV))
            kw = dict(causal=True, window=window, prefix_len=prefix)
            got = PK.prefill_attention(qq, kk, vv, **kw)
            err = (got - PK.prefill_attention_plain(qq, kk, vv, **kw)).abs().max().item()
            check(err <= 2e-5, f"B3 hd={hd} H={H} KV={KV} {kw}: {err}")
            worst = max(worst, err)
        print(f"C3 hd={hd} H={H} KV={KV}: B2 at cache_len {edge.tolist()} (W={W}) and B3 at "
              f"S={S} causal, window 64, prefix 37 within 2e-5 of plain; B2 rows == B=1 calls")
    print(f"C3: B2 and B3 at hd 256, 112 and 32: max abs err {worst:.2e}")


def takes_wide_heads() -> bool:
    """Whether B2 and B3 of the tree under test take hd > 256 (the rest of
    ROADMAP fault C3; an older tree, run with --src, refuses it: those
    checks are skipped)."""
    from repro_torch.kernels import decode_attention
    try:
        return decode_attention.instance_hd(264) == 264
    except (AttributeError, ValueError):      # no instance_hd, or it refuses hd 264
        return False


def check_wide_heads(dev, report: dict) -> None:
    """The rest of ROADMAP fault C3: B2 and B3 above the widest instance, at
    hd 264, 384 and 512, through the wide-head kernels. B2 at cache_len 0, 1
    and past W (and the chunk edges), each slot's row equal to its B=1
    call; B3 causal, windowed, with a prefix and bidirectional; each within
    2e-5 of the plain version. Timed at hd 512 against SDPA (under the
    backend that takes hd 512, named): B2 at the fleet's B=4 (16 / 16
    heads, W=512), at RaLMSeq's B=1 (L=512) and at 8 query heads a KV head
    (B=4, 16 / 2 heads), and B3 at S=160 causal. B2 also at W = 16,384
    (64 and 57 chunks merged) against the plain version."""
    from repro_torch.kernels import decode_attention as DK
    from repro_torch.kernels import prefill_attention as PK
    gen = torch.Generator(device=dev).manual_seed(11)
    W, S = 512, 160
    lens = torch.tensor([1, 97, 300, 512], dtype=torch.int32, device=dev)
    q, kc, vc = decode_inputs(gen, 4, W, 16, 16, 512, dev)
    before = DK.launches
    report["decode_attention@hd512"] = time_decode(DK, q, kc, vc, lens, gen)
    check(DK.launches > before, "B2 hd 512: no launch")
    report["decode_attention@hd512 B=1"] = time_decode(DK, q[3:4], kc[3:4], vc[3:4],
                                                       lens[3:4].clone(), gen)
    q, kc, vc = decode_inputs(gen, 4, W, 16, 2, 512, dev)
    report["decode_attention@hd512 G=8"] = time_decode(DK, q, kc, vc, lens, gen)
    long = torch.tensor([16384, 9000], dtype=torch.int32, device=dev)
    q, kc, vc = decode_inputs(gen, 2, 16384, 8, 2, 512, dev)
    err = (DK.decode_attention(q, kc, vc, long)
           - DK.decode_attention_plain(q, kc, vc, long)).abs().max().item()
    check(err <= 2e-5, f"B2 hd 512 W=16384 lens={long.tolist()}: {err}")
    print(f"B2 hd=512 H=8 KV=2 W=16384 cache_len={long.tolist()}: max abs err {err:.2e}")
    del q, kc, vc
    q, k, v = (torch.randn((1, S, 16, 512), generator=gen, device=dev) for _ in range(3))
    report["prefill_attention@hd512"] = time_prefill(
        PK, q, k, v, dict(causal=True, window=0, prefix_len=0),
        f"B=1 S={S} H=KV=16 hd=512 causal")
    edge = torch.tensor([0, 1, 31, 32, 33, 63, 64, 65, W, W + 9], dtype=torch.int32,
                        device=dev)
    worst = 0.0
    for hd, H, KV in ((264, 8, 1), (384, 16, 4), (512, 8, 2)):
        q, kc, vc = decode_inputs(gen, len(edge), W, H, KV, hd, dev)
        out = DK.decode_attention(q, kc, vc, edge)
        err = (out - DK.decode_attention_plain(q, kc, vc, edge)).abs().max().item()
        check(err <= 2e-5, f"B2 hd={hd} H={H} KV={KV} lens={edge.tolist()}: {err}")
        for b in range(len(edge)):
            one = DK.decode_attention(q[b:b + 1], kc[b:b + 1], vc[b:b + 1], edge[b:b + 1].clone())
            check(torch.equal(one[0], out[b]), f"B2 hd={hd}: slot {b}'s B=1 row != its row")
        worst = max(worst, err)
        for causal, window, prefix in ((True, 0, 0), (True, 64, 0), (True, 0, 37),
                                       (False, 0, 0)):
            qq, kk, vv = (torch.randn((2, S, h, hd), generator=gen, device=dev)
                          for h in (H, KV, KV))
            kw = dict(causal=causal, window=window, prefix_len=prefix)
            got = PK.prefill_attention(qq, kk, vv, **kw)
            err = (got - PK.prefill_attention_plain(qq, kk, vv, **kw)).abs().max().item()
            check(err <= 2e-5, f"B3 hd={hd} H={H} KV={KV} {kw}: {err}")
            worst = max(worst, err)
        print(f"C3 hd={hd} H={H} KV={KV} (wide-head kernels): B2 at cache_len {edge.tolist()} "
              f"(W={W}) and B3 at S={S} causal, window 64, prefix 37 and bidirectional within "
              f"2e-5 of plain; B2 rows == B=1 calls")
    print(f"C3 above hd 256: B2 and B3 at hd 264, 384 and 512: max abs err {worst:.2e}")


def check_encoder_prefill(dev, report: dict) -> None:
    """B3 at whisper-base's encoder shape: B=1, S=1500 frames, 8 / 8 heads
    at hd 64, bidirectional (``causal=False``), timed against SDPA."""
    from repro_torch.kernels import prefill_attention as PK
    gen = torch.Generator(device=dev).manual_seed(12)
    q, k, v = (torch.randn((1, 1500, 8, 64), generator=gen, device=dev) for _ in range(3))
    report["prefill_attention@encoder"] = time_prefill(
        PK, q, k, v, dict(causal=False, window=0, prefix_len=0),
        "B=1 S=1500 H=KV=8 hd=64 bidirectional (whisper-base's encoder)")


def same_as_unsharded(sh, whole, queries: np.ndarray, cands, label: str) -> None:
    """A sharded backend against its unsharded one, byte for byte, at B in
    {1, 4, 12} and k in {1, 20, 300}: search (launching its scan once a
    shard) and search_gathered over ``cands(queries[:B], k)``."""
    from repro_torch.kernels import dense_topk as DT
    from repro_torch.kernels import quant_topk as QT
    module = QT if sh.name.startswith("int8") else DT
    for B in (1, 4, 12):
        qs = queries[:B]
        for k in (1, 20, 300):
            before = module.launches
            got = sh.search(qs, k)
            check(module.launches - before == sh.n_shards,
                  f"{label} B={B} k={k}: not one scan launch a shard")
            want = whole.search(qs, k)
            check(np.array_equal(want[0], got[0]) and np.array_equal(want[1], got[1]),
                  f"{label} B={B} k={k}: search differs from {whole.name}")
            cand = cands(qs, k)
            got = sh.search_gathered(qs, cand, k)
            want = whole.search_gathered(qs, cand, k)
            check(np.array_equal(want[0], got[0]) and np.array_equal(want[1], got[1]),
                  f"{label} B={B} k={k}: search_gathered differs from {whole.name}")


def check_sharded(dev, kb_np: np.ndarray, fp32, qb, ivf, queries: np.ndarray,
                  report: dict) -> None:
    """``sharded`` against ``kernel`` and ``int8-sharded`` against
    ``int8-kernel``, byte for byte, on the serving KB: S in {2, 3, 4} (3
    does not divide 500,000), B in {1, 4, 12}, k in {1, 20, 300}, search
    and search_gathered over the ADR index's candidate matrix of real
    queries; a search launches its scan once a shard. Then one 4-shard
    search (``retrieval.sharded.sharded_dense_topk``, the per-shard scans
    and the merge) timed beside the unsharded kernel at B = 4 and 12, k = 20."""
    from repro_torch.kernels import dense_topk as DT
    from repro_torch.retrieval import sharded as SH
    from repro_torch.retrieval.backends import QuantizedShardedBackend, ShardedBackend
    N, d = kb_np.shape
    for S in (2, 3, 4):
        for cls, whole in ((ShardedBackend, fp32), (QuantizedShardedBackend, qb)):
            sh = cls(kb_np, n_shards=S, device=dev)
            check(sh.n_shards == S and all(r.is_cuda for r in sh._rows),
                  f"{cls.name} S={S}: shards off the card")
            same_as_unsharded(sh, whole, queries, lambda qs, k: ivf._gather_candidates(qs, k)[0],
                              f"{cls.name} S={S}")
            del sh
        print(f"S={S}: sharded == kernel and int8-sharded == int8-kernel byte for byte "
              f"(search, and search_gathered over the ADR candidates), B in {{1, 4, 12}}, "
              f"k in {{1, 20, 300}}; one scan launch a shard")
    sh = ShardedBackend(kb_np, n_shards=4, device=dev)
    kb = fp32._kb
    for B in (4, 12):
        q = torch.as_tensor(queries[:B], device=dev)
        t = timed(lambda: SH.sharded_dense_topk(q, sh._rows, 20, n_total=N),
                  lambda: DT.dense_topk(q, kb, 20))
        bms, by = bound_ms(4.0 * (N * d + B * d + 2 * B * 20), 2.0 * B * N * d)
        print(f"4-shard search B={B} k=20 on one card: {fmt_times(t, 'unsharded B1')}  "
              f"bound {bms:.4f} ms ({by})")
        report.setdefault("dense_topk@4shards", {})[f"B={B}"] = dict(
            shape=f"B={B} N={N} d={d} k=20, 4 shards on one card", bound_ms=bms,
            bound_by=by, device_ms=t["device_ms"], call_ms=t["call_ms"],
            unsharded_device_ms=t["library_device_ms"], unsharded_call_ms=t["library_call_ms"])
    del sh
    torch.cuda.empty_cache()


def check_sharded_across_cards(N: int = SERVE_N_DOCS, d: int = SERVE_ENC_DIM,
                               dev0=torch.device("cuda", 0)) -> None:
    """``--across-cards``: the sharded backends with their shards
    round-robin over every visible card (the default placement), the
    queries and the merge on cuda:0, against the unsharded kernel backends
    on cuda:0, byte for byte: one shard a card and 2 x cards + 1 shards
    (several a card, the last short), B in {1, 4, 12}, k in {1, 20, 300},
    search and search_gathered over random id-sorted candidate rows; each
    search launches its scan once a shard. Then the host seconds of one
    search at B=12, k=20, with every card synchronised, beside the
    unsharded one's. The KB is random unit rows (the kernels' scores are
    the same bytes whatever the rows), made on the host from numpy seed 13."""
    from repro_torch.retrieval.backends import (QuantizedShardedBackend, ShardedBackend,
                                                TorchKernelBackend,
                                                TorchQuantizedKernelBackend)
    cards = torch.cuda.device_count()
    rng = np.random.default_rng(13)
    kb = rng.standard_normal((N, d), dtype=np.float32)
    kb /= np.linalg.norm(kb, axis=1, keepdims=True)
    queries = kb[rng.choice(N, 12, replace=False)] + 0.1 * rng.standard_normal(
        (12, d), dtype=np.float32)
    C = min(40_000, N)
    cand = np.full((12, C), -1, np.int64)
    for b in range(12):
        w = int(rng.integers(1, C))
        cand[b, :w] = np.sort(rng.choice(N, size=w, replace=False))

    def sync_all():
        for i in range(cards):
            torch.cuda.synchronize(i)

    for cls, whole_cls in ((ShardedBackend, TorchKernelBackend),
                           (QuantizedShardedBackend, TorchQuantizedKernelBackend)):
        whole = whole_cls(kb, device=dev0)
        for S in (cards, 2 * cards + 1):
            sh = cls(kb, n_shards=S, device=dev0)
            on = sorted({r.device.index for r in sh._rows})
            check(on == list(range(cards)), f"{cls.name} S={S}: shards on cards {on}")
            same_as_unsharded(sh, whole, queries, lambda qs, k: cand[:len(qs)],
                              f"{cls.name} S={S} across {cards} cards")
            times = {}
            for name, be in (("sharded", sh), ("unsharded", whole)):
                for _ in range(3):
                    be.search(queries, 20)
                sync_all()
                t = time.perf_counter()
                for _ in range(20):
                    be.search(queries, 20)
                sync_all()
                times[name] = (time.perf_counter() - t) / 20 * 1e3
            print(f"{cls.name} over {S} shards on {cards} cards == {whole_cls.name} on cuda:0 "
                  f"byte for byte (search and search_gathered, B in {{1, 4, 12}}, k in "
                  f"{{1, 20, 300}}; one scan launch a shard); one search at B=12 k=20 "
                  f"{times['sharded']:.4f} ms host, unsharded {times['unsharded']:.4f} ms")
            del sh
        del whole
        torch.cuda.empty_cache()


# the one PyTorch call (or composed call) timed beside each kernel
LIBRARY_CALLS = {
    "dense_topk": "torch.topk(q @ kb.T)",
    "decode_attention": "scaled_dot_product_attention",
    "prefill_attention": "scaled_dot_product_attention(is_causal=True)",
    "fused_gathered_topk": "torch.topk(einsum(q, kb[cand]) masked)",
    "gathered_topk": "torch.topk(einsum(q, emb) masked)",
    "quant_dense_topk": "torch.topk((q @ codes.float().T) * scales)",
    "quant_fused_gathered_topk": "torch.topk(einsum(q, codes[cand].float()) * scales[cand] masked)",
    "quant_gathered_topk": "torch.topk(einsum(q, emb.float()) * scl masked)",
}


def ragged_cand(rng, B, C, N):
    """Id-sorted candidate rows of ragged width with -1 pads; row 0 repeats
    an id, row 2 is all pad."""
    cand = np.full((B, C), -1, np.int32)
    for b in range(B):
        if b != 2:
            w = int(rng.integers(1, min(C, N)))
            cand[b, :w] = np.sort(rng.choice(N, size=w, replace=False))
    cand[0, 1] = cand[0, 0]
    return cand


def gathered_args(q, kb, codes, scales, cand):
    """Each gathered scan's arguments: B4 and B7 take the resident KB, B5 and
    B8 the slabs gathered from it."""
    safe = cand.clamp(min=0).long()
    return {"fused_gathered_topk": (q, kb, cand),
            "gathered_topk": (q, kb[safe], cand),
            "quant_fused_gathered_topk": (q, codes, scales, cand),
            "quant_gathered_topk": (q, codes[safe], scales[safe], cand)}


def check_gathered(dev, kb, codes, scales, ivf, queries: np.ndarray, report: dict) -> None:
    """B4, B5, B7, B8 at the serving shape (the 500k x 768 KB and its int8
    codes, real queries, the ADR index's candidate matrix), then on a
    tie-heavy grid KB."""
    from repro_torch.kernels import gathered_topk as GT
    from repro_torch.retrieval.backends import quantize_kb
    d = kb.shape[1]
    for B in (1, 12):
        q = torch.as_tensor(queries[:B], device=dev)
        for k in scan_ks():
            cand_np, counts = ivf._gather_candidates(queries[:B], k)
            cand = torch.as_tensor(cand_np.astype(np.int32), device=dev)
            real = cand >= 0
            C, n_real = cand.shape[1], int(real.sum())
            n_rows = int(torch.unique(cand[real]).numel())   # distinct KB rows
            if k == 1:
                print(f"ADR candidate matrix at B={B}: C={C}, real candidates per query "
                      f"{counts.min()}..{counts.max()} (mean {counts.mean():.0f}), "
                      f"{n_real} in all, {n_rows} distinct KB rows")
            args = gathered_args(q, kb, codes, scales, cand)
            # the least bytes: each needed row once (distinct KB rows for the
            # resident KB, every real slab row for a slab), ids, q, results
            side = 4.0 * (B * C + B * d + 2 * B * k)
            need = {"fused_gathered_topk": n_rows * d * 4, "gathered_topk": n_real * d * 4,
                    "quant_fused_gathered_topk": n_rows * (d + 4),
                    "quant_gathered_topk": n_real * (d + 4)}
            out = {}
            for name, a in args.items():
                out[name] = getattr(GT, name)(*a, k)
                plain = getattr(GT, f"{name}_plain")(*a, k + 1)
                err, gap = compare_topk(f"{name} B={B} k={k}", *out[name], *plain, k)
                plain_ms = cuda_ms(lambda: getattr(GT, f"{name}_plain")(*a, k))
                quant = name.startswith("quant")
                safe = a[-1].clamp(min=0).long()

                def library():
                    if name == "fused_gathered_topk":
                        s = torch.einsum("bd,bcd->bc", q, kb[safe])
                    elif name == "gathered_topk":
                        s = torch.einsum("bd,bcd->bc", q, a[1])
                    elif name == "quant_fused_gathered_topk":
                        s = torch.einsum("bd,bcd->bc", q, codes[safe].float()) * scales[safe]
                    else:
                        s = torch.einsum("bd,bcd->bc", q, a[1].float()) * a[2]
                    return torch.topk(s.masked_fill(~real, GT.NEG), k)
                t = timed(lambda: getattr(GT, name)(*a, k), library)
                bms, by = bound_ms(need[name] + side, 2.0 * n_real * d + (n_real if quant else 0))
                print(f"{name} B={B:2d} k={k:3d} C={C}: {fmt_times(t, LIBRARY_CALLS[name])}  "
                      f"plain {plain_ms:.4f} ms  bound {bms:.4f} ms ({by})  max|dscore| "
                      f"{err:.2e}  rows with a clear k-th gap {int(gap.sum())}/{B}")
                if (B, k) == (12, 20):        # the fleet's merged psa probe
                    report[name] = dict(max_abs_err=err, plain_ms=plain_ms, bound_ms=bms,
                                        bound_by=by, shape=f"B={B} N={kb.shape[0]} d={d} "
                                                           f"C={C} real={n_real} "
                                                           f"distinct={n_rows} k={k}", **t)
                if B == 1:                    # RaLMSeq's probe, per k
                    report.setdefault(f"{name}@B=1", {})[f"k={k}"] = dict(
                        max_abs_err=err, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                        shape=f"B=1 C={C} real={n_real} distinct={n_rows}", **t)
            for x, y in (("fused_gathered_topk", "gathered_topk"),
                         ("quant_fused_gathered_topk", "quant_gathered_topk")):
                check(torch.equal(out[x][0], out[y][0]) and torch.equal(out[x][1], out[y][1]),
                      f"{x} != {y} at B={B} k={k}")
            del args, out
    # tie-heavy grid KB at the serving width: ragged C, a duplicate id, an
    # all-pad row; byte-identical to the plain versions, B=1 rows == B=12 rows
    rng = np.random.default_rng(4)
    gkb = grid_rows(rng, 375, d, dev).repeat(9, 1)[:3001].contiguous()
    gcodes, gscales = (torch.as_tensor(x, device=dev) for x in quantize_kb(gkb.cpu().numpy()))
    gq = grid_rows(rng, 12, d, dev)
    gcand = torch.as_tensor(ragged_cand(rng, 12, 1300, 3001), device=dev)
    args = gathered_args(gq, gkb, gcodes, gscales, gcand)
    for k in scan_ks():
        out = {}
        for name, a in args.items():
            out[name] = getattr(GT, name)(*a, k)
            plain = getattr(GT, f"{name}_plain")(*a, k)
            check(torch.equal(out[name][0], plain[0]) and torch.equal(out[name][1], plain[1]),
                  f"{name} grid k={k}: kernel != plain")
            one = getattr(GT, name)(*(t[:1].contiguous() if t.shape[0] == 12 else t
                                      for t in a), k)
            check(torch.equal(one[0][0], out[name][0][0]) and torch.equal(one[1][0], out[name][1][0]),
                  f"{name} grid k={k}: B=1 row != B=12 row")
        check(torch.equal(out["fused_gathered_topk"][1], out["gathered_topk"][1])
              and torch.equal(out["fused_gathered_topk"][0], out["gathered_topk"][0])
              and torch.equal(out["quant_fused_gathered_topk"][1], out["quant_gathered_topk"][1])
              and torch.equal(out["quant_fused_gathered_topk"][0], out["quant_gathered_topk"][0]),
              f"grid k={k}: fused != pre-gathered")
        check(bool((out["fused_gathered_topk"][1][2] == -1).all()), "all-pad row not (NEG, -1)")
    print(f"B4 B5 B7 B8 grid KB N=3001 d={d} (tie-heavy), B=12 C=1300 ragged with a "
          f"duplicate id and an all-pad row, k in {set(scan_ks())}: kernel == plain byte "
          f"for byte, B4 == B5, B7 == B8, B=1 rows == B=12 rows")


def check_any_d(dev) -> None:
    """ROADMAP fault C1: both kernel backends at d = 6 and 50 (KB padded at
    upload, queries per call), k = 20 and 300, full and gathered scans,
    against the numpy backends byte for byte on a tie-heavy grid KB; every
    call launches its kernel."""
    from repro_torch.retrieval.backends import (FlatBackend, QuantizedFlatBackend,
                                                TorchKernelBackend,
                                                TorchQuantizedKernelBackend)
    rng = np.random.default_rng(6)
    for d in (6, 50):
        emb = grid_rows(rng, 375, d, dev).repeat(8, 1)[:3000].cpu().numpy()
        flat, kern = FlatBackend(emb), TorchKernelBackend(emb, device=dev)
        qflat, qkern = QuantizedFlatBackend(emb), TorchQuantizedKernelBackend(emb, device=dev)
        qs = grid_rows(rng, 3, d, dev).cpu().numpy()
        cand = ragged_cand(rng, 3, 700, 3000).astype(np.int64)
        for k in (20, 300):
            for label, want, call, kernel in (
                    ("kernel search", flat.search(qs, k), lambda: kern.search(qs, k),
                     "dense_topk"),
                    ("int8-kernel search", qflat.search(qs, k), lambda: qkern.search(qs, k),
                     "quant_dense_topk"),
                    ("kernel search_gathered", flat.search_gathered(qs, cand, k),
                     lambda: kern.search_gathered(qs, cand, k), "fused_gathered_topk"),
                    ("int8-kernel search_gathered", qflat.search_gathered(qs, cand, k),
                     lambda: qkern.search_gathered(qs, cand, k), "quant_fused_gathered_topk")):
                before = read_counts()[kernel]
                got = call()
                check(read_counts()[kernel] == before + 1, f"C1 {label} d={d} k={k}: no launch")
                check(np.array_equal(want[0], got[0]) and np.array_equal(want[1], got[1]),
                      f"C1 {label} d={d} k={k}: differs from the numpy backend")
    print("C1: kernel and int8-kernel backends at d in {6, 50}, B=3, N=3000, k in {20, 300} "
          "(search and search_gathered, C=700) == numpy backends byte for byte; each call "
          "launched its kernel")


def check_quant_topk(dev, codes, scales, queries: np.ndarray, report: dict) -> None:
    """B6 over the int8 codes of the serving KB at B in {1, 12, 64}, with B1's
    checks, then byte equality and batch invariance on a tie-heavy grid KB."""
    from repro_torch.kernels import quant_topk as K
    from repro_torch.retrieval.backends import quantize_kb
    N, d = codes.shape
    for B in (1, 12, 64):
        q = torch.as_tensor(queries[:B], device=dev)
        for k in scan_ks():
            s_k, i_k = K.quant_dense_topk(q, codes, scales, k)
            s_p, i_p = K.quant_dense_topk_plain(q, codes, scales, k + 1)
            err, gap = compare_topk(f"B6 B={B} k={k}", s_k, i_k, s_p, i_p, k)
            plain = cuda_ms(lambda: K.quant_dense_topk_plain(q, codes, scales, k))
            t = timed(lambda: K.quant_dense_topk(q, codes, scales, k),
                      lambda: torch.topk((q @ codes.float().T) * scales, k))
            bms, by = bound_ms(N * d + 4.0 * (N + B * d + 2 * B * k),
                               2.0 * B * N * d + B * N)
            print(f"B6 quant_dense_topk N={N} d={d} B={B:3d} k={k:3d}: "
                  f"{fmt_times(t, 'torch.topk((q@codes.float().T)*scales)')}  "
                  f"plain {plain:.4f} ms  bound {bms:.4f} ms ({by})  max|dscore| {err:.2e}  "
                  f"rows with a clear k-th gap {int(gap.sum())}/{B}")
            if (B, k) == (12, 20):
                report["quant_dense_topk"] = dict(max_abs_err=err, plain_ms=plain, bound_ms=bms,
                                                  bound_by=by, shape=f"B={B} N={N} d={d} k={k} "
                                                                     f"int8", **t)
    rng = np.random.default_rng(5)
    gcodes, gscales = (torch.as_tensor(x, device=dev) for x in quantize_kb(
        grid_rows(rng, 375, 64, dev).repeat(9, 1)[:3001].cpu().numpy()))
    qs = grid_rows(rng, 12, 64, dev)
    for k in scan_ks():
        s12, i12 = K.quant_dense_topk(qs, gcodes, gscales, k)
        s1, i1 = K.quant_dense_topk(qs[:1].contiguous(), gcodes, gscales, k)
        sp, ip = K.quant_dense_topk_plain(qs, gcodes, gscales, k)
        check(torch.equal(s12, sp) and torch.equal(i12, ip), f"B6 grid k={k}")
        check(torch.equal(s1, s12[:1]) and torch.equal(i1, i12[:1]), f"B6 B=1 vs 12 k={k}")
    print(f"B6 grid KB N=3001 d=64 (tie-heavy), k in {set(scan_ks())}: kernel == plain "
          f"byte for byte, B=1 rows == B=12 rows")


# ---------------------------------------------------------------------------------
# phase 4: the port's main paths at full width
# ---------------------------------------------------------------------------------
def kernel_modules():
    from repro_torch.kernels import (decode_attention, dense_topk, gathered_topk,
                                     prefill_attention, quant_topk)
    return dense_topk, decode_attention, prefill_attention, quant_topk, gathered_topk


def reset_counts() -> None:
    set_counts(dict.fromkeys(read_counts(), 0))


def set_counts(counts: dict) -> None:
    dense, decode, prefill, quant, gathered = kernel_modules()
    dense.launches, decode.launches = counts["dense_topk"], counts["decode_attention"]
    prefill.launches, quant.launches = counts["prefill_attention"], counts["quant_dense_topk"]
    for name in gathered.launches:
        gathered.launches[name] = counts[name]


def read_counts() -> dict:
    dense, decode, prefill, quant, gathered = kernel_modules()
    return {"dense_topk": dense.launches, "decode_attention": decode.launches,
            "prefill_attention": prefill.launches, "quant_dense_topk": quant.launches,
            **gathered.launches}


class RecordingBackend:
    """Delegates to a backend and keeps each query batch (and candidate
    matrix) it is asked, for the recall check after serving."""

    def __init__(self, inner):
        self.inner = inner
        self.asked = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def search(self, queries, k):
        self.asked.append((queries, None))
        return self.inner.search(queries, k)

    def search_gathered(self, queries, cand, k):
        self.asked.append((queries, cand))
        return self.inner.search_gathered(queries, cand, k)


def build_serving(dev):
    """The EDR stack at full width over the 500k x 768 KB, the ADR index over
    the same KB on the same kernel backend, and the int8 kernel backend."""
    from repro_torch.configs import RaLMConfig
    from repro_torch.launch.serve import build_stack, variant_config
    from repro_torch.retrieval.backends import TorchQuantizedKernelBackend
    from repro_torch.retrieval.retrievers import IVFRetriever

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
    t0 = time.perf_counter()
    ivf = IVFRetriever(stack.retriever.kb, backend=stack.retriever.backend)
    sizes = np.asarray([len(b) for b in ivf.buckets])
    print(f"ADR index: {len(sizes)} clusters, nprobe {ivf.nprobe}, buckets "
          f"{sizes.min()}..{sizes.max()} docs, C = {ivf._cand_width(20)}; k-means on the "
          f"host in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    qb = TorchQuantizedKernelBackend(stack.retriever.kb.embeddings, device=dev)
    print(f"int8 KB: {qb.kb_bytes / 1e9:.3f} GB of codes and scales on the card; "
          f"quantized in {time.perf_counter() - t0:.1f} s")
    return stack, ivf, qb


def serve_path(stack, prompts, label: str, kernels, extra=None) -> tuple:
    """The sequential baseline (RaLMSeq, or KNNLMSeq for KNN-LM), then a
    4-slot psa fleet, over one stack: the tokens must be identical (KNN-LM:
    token-match), every fleet group must make one merged KB call per round
    plus its seed call, and each kernel in ``kernels`` must have been
    launched. ``extra`` (an audio model's frames) goes to the engines, which
    hand it to every prefill. The launch counts are set to 0 just before and
    read just after. Returns (counts, the baseline's tokens, the KB calls of
    both servers)."""
    from repro_torch.launch.serve import make_server
    from repro_torch.serving.batched import BatchedServeEngine
    from repro_torch.serving.engine import ServeEngine
    base = "KNNLMSeq" if stack.workload.name == "knnlm" else "RaLMSeq"
    eng = beng = None
    if extra is not None:
        eng = ServeEngine(stack.model, stack.params, cache_window=512, extra=extra)
        beng = BatchedServeEngine(stack.model, stack.params, 4, cache_window=512,
                                  extra=extra)
    reset_counts()
    torch.cuda.synchronize()
    seq = make_server(stack, scheduler="seq", engine=eng)
    t = time.perf_counter()
    seq_res, seq_prefills = [], 0
    for p in prompts:
        seq_res.append(seq.serve(p))
        seq_prefills += seq.engine.stats.prefills     # the engine's counts are per request
    seq_wall = time.perf_counter() - t
    n_tok = sum(len(r.tokens) for r in seq_res)
    print(f"{label} {base}   x{len(prompts)}: wall {seq_wall:.3f} s  G "
          f"{sum(r.gen_time for r in seq_res):.3f} s  R "
          f"{sum(r.retrieval_time for r in seq_res):.3f} s  {n_tok / seq_wall:.1f} tok/s  "
          f"KB calls {sum(r.kb_calls for r in seq_res)}  prefills {seq_prefills}")
    fleet_res, fleet_wall, rounds, kb_calls, fleet_prefills = [], 0.0, 0, 0, 0
    with make_server(stack, scheduler="fixed", n_slots=4, engine=beng) as fleet:
        for i in range(0, len(prompts), 4):
            fr = fleet.serve(prompts[i:i + 4])
            fleet_prefills += fleet.engine.stats.prefills   # per group
            check(fr.kb_errors == 0 and fr.degraded_rounds == 0 and fr.worker_crashes == 0,
                  f"{label}: a fleet KB call failed")
            check(fr.kb_calls == fr.rounds + 1,
                  f"{label}: {fr.kb_calls} KB calls in {fr.rounds} rounds")
            fleet_res += fr.results
            fleet_wall += fr.wall_time
            rounds += fr.rounds
            kb_calls += fr.kb_calls
    torch.cuda.synchronize()
    counts = read_counts()
    g = sum(r.gen_time for r in fleet_res[::4])       # one fleet-wide ledger per group
    r_t = sum(r.retrieval_time for r in fleet_res[::4])
    print(f"{label} Fleet x4 psa x{len(prompts)}: wall {fleet_wall:.3f} s  G {g:.3f} s  "
          f"R {r_t:.3f} s  {n_tok / fleet_wall:.1f} tok/s  rounds {rounds}  KB calls "
          f"{kb_calls}  prefills {fleet_prefills}  speed-up over {base} "
          f"{seq_wall / fleet_wall:.2f}x")
    same = [a.tokens == b.tokens for a, b in zip(seq_res, fleet_res)]
    kind = "outputs token-match" if base == "KNNLMSeq" else "outputs identical"
    print(f"{label}: launches {({n: c for n, c in counts.items() if c})}  {kind}: {all(same)}")
    check(all(same), f"{label}: fleet tokens differ from {base}: {same}")
    n_new = stack.rcfg.max_new_tokens
    check(all(len(r.tokens) == n_new for r in seq_res), f"{label}: {base} stopped short")
    check(all(len(r.tokens) == n_new for r in fleet_res), f"{label}: the fleet stopped short")
    check(all(counts[n] > 0 for n in kernels), f"{label}: a kernel was not launched: {counts}")
    return counts, [r.tokens for r in seq_res], sum(r.kb_calls for r in seq_res) + kb_calls


def serve_faults(stack, prompts, want, label: str) -> dict:
    """The EDR fleet with a seeded fault schedule injected into its KB path
    (a fresh retriever over the same KB and kernel backend): the injector
    must fire, every error must be retried away (no round degraded, no
    worker crashed), and the tokens must be RaLMSeq's."""
    from repro_torch.launch.serve import make_server
    from repro_torch.retrieval.faults import inject_faults, parse_fault_spec
    from repro_torch.retrieval.retrievers import ExactDenseRetriever
    retr = ExactDenseRetriever(stack.retriever.kb, backend=stack.retriever.backend)
    inj = inject_faults(retr, parse_fault_spec("p_error=0.2,seed=3"))
    st = dataclasses.replace(stack, retriever=retr, engine=None)
    reset_counts()
    torch.cuda.synchronize()
    with make_server(st, scheduler="fixed", n_slots=4) as fleet:
        fr = fleet.serve(prompts)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"{label} Fleet x4 psa x{len(prompts)}: wall {fr.wall_time:.3f} s  injected "
          f"{inj.errors} errors over {inj.calls} KB scans; retried {fr.kb_errors}, failed "
          f"{fr.kb_failures}, degraded rounds {fr.degraded_rounds}, worker crashes "
          f"{fr.worker_crashes}, rounds {fr.rounds}  launches "
          f"{({n: c for n, c in counts.items() if c})}")
    check(inj.injected > 0, f"{label}: the injector never fired")
    check(fr.kb_errors == inj.errors and fr.kb_failures == 0, f"{label}: a call failed")
    check(fr.degraded_rounds == 0 and fr.worker_crashes == 0,
          f"{label}: {fr.degraded_rounds} degraded rounds, {fr.worker_crashes} crashes")
    same = [r.tokens == w for r, w in zip(fr.results, want)]
    print(f"{label}: outputs identical to RaLMSeq: {all(same)}")
    check(all(same), f"{label}: tokens differ from RaLMSeq: {same}")
    check(counts["dense_topk"] > 0, f"{label}: B1 was not launched")
    return counts


def serve_continuous(stack, prompts, want, label: str) -> dict:
    """ContinuousFleetServer, 4 slots, the prompts arriving as a Poisson
    process on the modeled clock: each request must give KNNLMSeq's tokens,
    every round one KB call plus the batched seed calls, and some request
    must have waited for a slot."""
    from repro_torch.launch.serve import make_arrivals, make_server
    from repro_torch.serving.continuous import as_requests
    arrivals = make_arrivals(len(prompts), KNN_ARRIVAL_RATE, seed=0)
    reset_counts()
    torch.cuda.synchronize()
    with make_server(stack, scheduler="continuous", n_slots=4) as srv:
        cr = srv.serve(as_requests(prompts, arrivals))
    torch.cuda.synchronize()
    counts = read_counts()
    finish = [a + lat for a, lat in zip(arrivals, cr.latencies)]
    # request j waited when the slots were all busy at its arrival
    waited = sum(1 for j in range(4, len(prompts))
                 if sum(finish[i] <= arrivals[j] for i in range(j)) < j - 3)
    n_tok = cr.total_tokens
    print(f"{label} Continuous x4 psa x{len(prompts)} (Poisson {KNN_ARRIVAL_RATE} req/s, "
          f"arrivals {', '.join(f'{a:.3f}' for a in arrivals)} s): wall {cr.wall_time:.3f} s "
          f"({n_tok / cr.wall_time:.1f} tok/s)  modeled makespan {cr.analytic_time:.3f} s  "
          f"latency p50 {cr.p50:.3f} s p99 {cr.p99:.3f} s (modeled)  rounds {cr.rounds}  "
          f"seed calls {cr.seed_calls}  KB calls {cr.kb_calls}  peak live {cr.max_live}  "
          f"requests that waited for a slot {waited}")
    check(cr.kb_calls == cr.rounds + cr.seed_calls,
          f"{label}: {cr.kb_calls} KB calls, {cr.rounds} rounds, {cr.seed_calls} seeds")
    check(cr.kb_errors == 0 and cr.degraded_rounds == 0 and cr.shed == 0,
          f"{label}: a KB call failed or a request was shed")
    check(waited > 0 and cr.max_live == 4, f"{label}: no request queued")
    same = [r.tokens == w for r, w in zip(cr.results, want)]
    print(f"{label}: launches {({n: c for n, c in counts.items() if c})}  outputs "
          f"token-match: {all(same)}")
    check(all(same), f"{label}: tokens differ from KNNLMSeq: {same}")
    check(all(counts[n] > 0 for n in ("dense_topk", "decode_attention",
                                      "prefill_attention")),
          f"{label}: a kernel was not launched: {counts}")
    return counts


@contextlib.contextmanager
def host_seconds(module, names):
    """Host seconds spent in each of ``module``'s functions ``names`` while
    the block runs: the parts of a ``build_stack`` call, which keeps no
    times of its own."""
    saved = {n: getattr(module, n) for n in names}
    spent = dict.fromkeys(names, 0.0)

    def timed(name, fn):
        def call(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[name] += time.perf_counter() - t
        return call

    for n, fn in saved.items():
        setattr(module, n, timed(n, fn))
    try:
        yield spent
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def build_knnlm(dev):
    """knnlm-247m as published over the 1M x 1024 datastore (EDR, kernel
    backend), and the ADR index over the same datastore and backend."""
    from repro_torch.configs import RaLMConfig
    from repro_torch.launch import serve
    from repro_torch.retrieval.retrievers import IVFRetriever
    t0 = time.perf_counter()
    rcfg = serve.variant_config("psa", RaLMConfig(knnlm=True, max_new_tokens=48))
    parts = ("synthetic_corpus", "build_knn_datastore", "ExactDenseRetriever")
    with host_seconds(serve, parts) as spent:
        stack = serve.build_stack("edr", arch="knnlm-247m", full_width=True,
                                  workload="knnlm", n_docs=KNN_N_DOCS, enc_dim=KNN_KEY_DIM,
                                  knn_entries=KNN_ENTRIES, backend="kernel", device=dev,
                                  rcfg=rcfg)
    cfg, kb = stack.cfg, stack.retriever.kb
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
           cfg.d_ff, cfg.vocab_size) == (16, 1024, 16, 16, 64, 4096, 50304),
          "the KNN-LM stack is not knnlm-247m as published")
    check(len(stack.stream) == KNN_N_DOCS * 48 and kb.embeddings.shape ==
          (KNN_ENTRIES, KNN_KEY_DIM), f"datastore {kb.embeddings.shape}")
    print(f"KNN-LM stack: {cfg.name} {cfg.num_layers} layers d_model {cfg.d_model} heads "
          f"{cfg.num_heads}/{cfg.num_kv_heads} head_dim {cfg.head_dim} d_ff {cfg.d_ff} vocab "
          f"{cfg.vocab_size}; datastore {kb.embeddings.shape} from a {len(stack.stream)}-token "
          f"stream, {stack.retriever.backend.kb_bytes / 1e9:.2f} GB on the card; host "
          f"seconds: corpus {spent['synthetic_corpus']:.1f}, datastore "
          f"{spent['build_knn_datastore']:.1f}, upload {spent['ExactDenseRetriever']:.1f}; "
          f"built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ivf = IVFRetriever(kb, backend=stack.retriever.backend)
    sizes = np.asarray([len(b) for b in ivf.buckets])
    print(f"KNN-LM ADR index: {len(sizes)} clusters, nprobe {ivf.nprobe}, buckets "
          f"{sizes.min()}..{sizes.max()} entries, C = {ivf._cand_width(8)}; k-means (8 "
          f"iterations) on the host in {time.perf_counter() - t0:.1f} s")
    return stack, ivf


def serve_sharded(stack, ivf, prompts, want: dict, dev) -> dict:
    """The sharded backends at full width, as ``--mesh-shards 4`` builds
    them: the serving KB cut into 4 shards on the card, a fresh EDR
    retriever over ``sharded`` (8 prompts) and over ``int8-sharded``, and
    the ADR index over each (4 prompts each). Each path's RaLMSeq and fleet
    tokens must equal the unsharded backend's path's (``want``), the
    backend must count one call per search (rounds + seeds in the fleet),
    and the EDR paths must launch their scan once a shard a call."""
    from repro_torch.retrieval.retrievers import ExactDenseRetriever, RetrieverStats
    kb = stack.retriever.kb
    paths = {}
    for name, base, scan, gathered in (
            ("sharded", "kernel", "dense_topk", "fused_gathered_topk"),
            ("int8-sharded", "int8-kernel", "quant_dense_topk", "quant_fused_gathered_topk")):
        t0 = time.perf_counter()
        edr = ExactDenseRetriever(kb, backend=name, device=dev, mesh_shards=4)
        be = edr.backend
        print(f"{name}: {be.n_shards} shards of {[r.shape[0] for r in be._rows]} rows on "
              f"{', '.join(sorted(set(map(str, be.devices))))}, {be.kb_bytes / 1e9:.3f} GB; "
              f"built in {time.perf_counter() - t0:.1f} s")
        n = len(prompts) if name == "sharded" else 4
        for kind, retr, label_kernel in (("EDR", edr, scan), ("ADR", None, gathered)):
            if retr is None:                       # the same index, the sharded backend
                retr = copy.copy(ivf)
                retr.backend, retr.stats = be, RetrieverStats("linear_intercept")
                n = 4
            st = dataclasses.replace(stack, retriever=retr, retriever_kind=kind.lower(),
                                     backend=name, engine=None)
            label = f"{kind} {name}"
            c0 = be.calls
            counts, tokens, kb_calls = serve_path(st, prompts[:n], label, (label_kernel,))
            check(be.calls - c0 == kb_calls,
                  f"{label}: the backend counted {be.calls - c0} calls, the servers {kb_calls}")
            if kind == "EDR":
                check(counts[scan] == be.n_shards * kb_calls,
                      f"{label}: {counts[scan]} scan launches for {kb_calls} calls")
            same = tokens == want[f"{kind} {base}"][:n]
            print(f"{label}: {kb_calls} calls, {counts[label_kernel]} launches of "
                  f"{label_kernel}; tokens identical to the {kind} {base} path: {same}")
            check(same, f"{label}: tokens differ from the {kind} {base} path's")
            paths[label] = counts
        del edr, be, retr, st
        gc.collect()
        torch.cuda.empty_cache()
    return paths


def check_datastore_topk(dev, kb, asked, report: dict) -> None:
    """B1 at the KNN-LM datastore's shape (N = 1M, d = 1024, k = 8) on the
    queries the KNN-LM paths asked: at B = 1 (KNNLMSeq) and at the largest
    merged B of the fleet; checked against the plain version, a query's row
    against its row in the largest batch, and timed against the library."""
    from repro_torch.kernels import dense_topk as K
    N, d = kb.shape
    k = 8
    big = max((q for q, _ in asked), key=len)
    rows = {}
    for q_np in (big[:1], big):
        B = len(q_np)
        q = torch.as_tensor(np.ascontiguousarray(q_np), device=dev)
        s_k, i_k = rows[B] = K.dense_topk(q, kb, k)
        s_p, i_p = K.dense_topk_plain(q, kb, k + 1)
        err, gap = compare_topk(f"B1 datastore B={B}", s_k, i_k, s_p, i_p, k)
        t = timed(lambda: K.dense_topk(q, kb, k), lambda: torch.topk(q @ kb.T, k))
        plain = cuda_ms(lambda: K.dense_topk_plain(q, kb, k))
        bms, by = bound_ms(4.0 * (N * d + B * d + 2 * B * k), 2.0 * B * N * d)
        print(f"B1 dense_topk datastore N={N} d={d} B={B:3d} k={k}: "
              f"{fmt_times(t, 'torch.topk(q@kb.T)')}  plain {plain:.4f} ms  "
              f"bound {bms:.4f} ms ({by})  max|dscore| {err:.2e}  "
              f"rows with a clear k-th gap {int(gap.sum())}/{B}")
        report.setdefault("dense_topk@datastore", {})[f"B={B}"] = dict(
            max_abs_err=err, plain_ms=plain, bound_ms=bms, bound_by=by,
            shape=f"B={B} N={N} d={d} k={k}", **t)
    B = len(big)
    check(torch.equal(rows[1][0][0], rows[B][0][0]) and torch.equal(rows[1][1][0], rows[B][1][0]),
          f"B1 datastore: the B=1 row != its row at B={B}")
    print(f"B1 datastore: the B=1 row == its row at B={B} byte for byte")


# the model families beside dense that the port serves, at full width:
# (arch, what the config must hold: layers, d_model, heads, KV heads,
# head_dim, vocab) -- each over the RaLM paths' 500k x 768 KB
FAMILY_PATHS = (("qwen2-moe-a2.7b", (24, 2048, 16, 16, 128, 151936)),
                ("xlstm-350m", (24, 1024, 4, 4, 256, 50304)),
                ("paligemma-3b", (18, 2048, 8, 1, 256, 257216)),
                ("whisper-base", (6, 512, 8, 8, 64, 51865)))
FAMILY_PROMPTS = 4


def serve_family(arch: str, want: tuple, base, prompts, dev) -> dict:
    """One model family at full width through ``build_stack(arch=...,
    full_width=True)`` (random fp32 weights from seed 0, drawn on the card),
    retrieving over ``base``'s passages, KB and kernel backend (the stack's
    own small KB is dropped). Its own encoder spans the model's vocab and
    shares its first rows with ``base``'s (one seeded stream), so the KB is
    what it encodes for those passages, whose token ids fit every vocab:
    RaLMSeq against the 4-slot psa fleet through ``serve_path``, B1 always
    launched and B2 and B3 wherever the model has attention layers. An
    audio model (whisper-base) is served as the reference serves one: its
    engines hand the encoder frames, (1, 1500, d) from numpy seed 0, to
    every prefill. Prints the parameter count, the peak device memory, and
    one B=1 re-prefill at S = 144 (a passage, a prompt and 48 generated
    tokens) timed with CUDA events, with the encoder's share apart."""
    from repro_torch.launch.serve import build_stack
    from repro_torch.tree import tree_leaves
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fam = build_stack("edr", arch=arch, full_width=True, backend="kernel", n_docs=64,
                      enc_dim=SERVE_ENC_DIM, device=dev, rcfg=base.rcfg)
    n_base = base.encoder.table.shape[0]
    check(np.array_equal(fam.encoder.table[:n_base], base.encoder.table),
          f"{arch}: its encoder's first {n_base} rows are not the KB's encoder")
    fam = dataclasses.replace(fam, docs=base.docs, retriever=base.retriever)
    cfg = fam.cfg
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
           cfg.vocab_size) == want, f"{arch} is not full width: {cfg}")
    n_params = sum(t.numel() for t in tree_leaves(fam.params))
    kinds = cfg.layer_kinds()
    print(f"{arch} stack: family {cfg.family}, {cfg.num_layers} layers "
          f"({', '.join(f'{kinds.count(k)} {k}' for k in dict.fromkeys(kinds))}), d_model "
          f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads}, head_dim "
          f"{cfg.head_dim}, vocab {cfg.vocab_size}"
          + (f", {cfg.moe.num_experts} experts top-{cfg.moe.top_k} + "
             f"{cfg.moe.num_shared_experts} shared" if cfg.moe else "")
          + f"; {n_params / 1e9:.2f}B params ({n_params * 4 / 2**30:.1f} GiB fp32) drawn on "
          f"the card in {time.perf_counter() - t0:.1f} s")
    attn = "attn" in kinds
    kernels = ("dense_topk",) + (("decode_attention", "prefill_attention") if attn else ())
    extra = None
    if cfg.family == "audio":
        check(cfg.encoder_layers == 6 and cfg.encoder_frames == 1500,
              f"{arch}: the encoder is not as published")
        frames = np.random.default_rng(0).standard_normal(
            (1, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
        extra = {"frames": torch.as_tensor(frames, device=dev)}
    counts, _, _ = serve_path(fam, prompts, arch, kernels, extra=extra)
    if not attn:
        check(counts["decode_attention"] == counts["prefill_attention"] == 0,
              f"{arch}: an attention kernel ran in a model without attention: {counts}")
    ctx = list(base.docs[0]) + [t for p in prompts for t in p]
    toks = torch.as_tensor([ctx[:144]], device=dev)
    with torch.no_grad():
        ms = cuda_ms(lambda: fam.model.prefill(fam.params, toks, extra=extra,
                                               window_cache=512),
                     windows=3, inner=1, warmup=1)
        enc = ""
        if extra is not None:
            enc_ms = cuda_ms(lambda: fam.model.encode(fam.params, extra["frames"]),
                             windows=3, inner=1, warmup=1)
            enc = f", of which the encoder over {cfg.encoder_frames} frames {enc_ms:.1f} ms"
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{arch}: one B=1 re-prefill at S={toks.shape[1]} takes {ms:.1f} ms (CUDA "
          f"events){enc}; peak device memory {peak:.2f} GiB")
    return counts


# ---------------------------------------------------------------------------------
# phase 5: training
# ---------------------------------------------------------------------------------
TRAIN_REDUCED = ("llama3.2-1b", "qwen2-moe-a2.7b", "xlstm-350m", "paligemma-3b",
                 "whisper-base")             # dense, MoE (capacity), SSM, VLM, audio
TRAIN_ARCH = "knnlm-247m"
TRAIN_WANT = (16, 1024, 16, 16, 64, 50304)   # layers, d_model, heads, KV heads, hd, vocab
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 50, 8, 128
STEP_TOL = 1e-4        # loss, aux, grad norm: rtol = atol, as tests/test_torch_training.py
PARAM_ATOL = 2e-5      # parameters after a step, where |first moment| >= 1e-6


def params_close(a, b, mu, lr: float, what: str) -> float:
    """Two parameter trees after the same Adam step: within PARAM_ATOL where
    the step's first moment is at least 1e-6 in magnitude, and within 2 lr
    below it (there Adam's normalised step turns rounding into a step of up
    to lr either way: tests/test_torch_training.py). -> the largest
    difference over the first kind."""
    from repro_torch.tree import tree_leaves
    worst = 0.0
    for x, y, m in zip(tree_leaves(a), tree_leaves(b), tree_leaves(mu)):
        err = (x.to(y.device) - y).abs()
        noisy = m.to(y.device).abs() < 1e-6
        worst = max(worst, float(torch.where(noisy, 0.0, err).max()))
        check(float(err.max()) <= 2 * lr, f"{what}: a parameter moved more than 2 lr apart")
    check(worst <= PARAM_ATOL, f"{what}: parameters {worst:.3g} apart")
    return worst


def check_train_reduced(dev) -> None:
    """One train step at ``reduced()`` size per family, from the same
    parameters (drawn on the CPU from seed 0) and SyntheticLM batch (4 x 32,
    zero frames or patches), on the card and on the CPU: loss, aux, grad
    norm and the updated parameters agree. Then B3 and B2 refuse CUDA inputs
    that require grad, and launch nothing."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.prefill_attention import prefill_attention
    from repro_torch.launch.train import add_extra
    from repro_torch.models.model import Model
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig, init_adamw
    from repro_torch.training.trainer import make_train_step, to_device
    from repro_torch.tree import tree_map
    cpu = torch.device("cpu")
    for arch in TRAIN_REDUCED:
        cfg = reduced(get_config(arch))
        params = Model(cfg).init(torch.Generator().manual_seed(0))
        batch = add_extra(cfg, SyntheticLM(cfg.vocab_size, 32, 4).batch(1))
        out = {}
        for d in (cpu, dev):
            p = tree_map(lambda t: t.to(d), params)
            step = make_train_step(Model(cfg), AdamWConfig(lr=1e-3, warmup_steps=2,
                                                            total_steps=10))
            out[d.type] = step(p, init_adamw(p), to_device(batch, d))
        (p0, s0, m0), (p1, _, m1) = out["cpu"], out["cuda"]
        for k in ("loss", "aux", "grad_norm", "lr"):
            a, b = float(m0[k]), float(m1[k])
            check(abs(a - b) <= STEP_TOL * (1 + abs(a)), f"train {arch}: {k} cpu {a} card {b}")
        worst = params_close(p0, p1, s0.mu, float(m0["lr"]), f"train {arch}")
        print(f"train step, reduced {arch} ({cfg.family}): loss cpu {float(m0['loss']):.6f} "
              f"card {float(m1['loss']):.6f}, aux {float(m1['aux']):.6f}, grad norm cpu "
              f"{float(m0['grad_norm']):.6f} card {float(m1['grad_norm']):.6f}, params "
              f"{worst:.2e} apart")
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((1, 16, 4, 64), generator=g, device=dev).requires_grad_()
    k = torch.randn((1, 16, 4, 64), generator=g, device=dev)
    lens = torch.full((1,), 16, dtype=torch.int32, device=dev)
    before = read_counts()
    for name, call in (("B3", lambda: prefill_attention(q, k, k)),
                       ("B2", lambda: decode_attention(q[:, 0], k, k, lens))):
        try:
            call()
        except RuntimeError as e:
            check("no backward" in str(e), f"{name}: {e}")
        else:
            raise RuntimeError(f"check failed: {name} ran on inputs that require grad")
    check(read_counts() == before, "a wrapper launched on inputs that require grad")
    print("B3 and B2 refuse CUDA inputs that require grad (nothing launched)")


def train_full(dev) -> dict:
    """knnlm-247m as published, trained through ``launch.train.train`` (the
    CLI's loop): SyntheticLM batches of 8 x 128, AdamW with 20 warmup steps,
    50 steps; the loss must fall. Prints ms per step (CUDA events, steps 11-50),
    tokens/s, peak device memory, the attention core's share of a step
    (plain attention forward and backward at the step's shape, x 16 layers),
    and the step's parts timed alone (forward, forward + backward, AdamW).
    Then the eval step (B3, no grad) against the differentiable route's
    loss within 1e-5 relative, ``forward(last_only=True)`` (B3) against the
    last position of the full logits, a 2-microbatch step against the
    1-microbatch step, and a checkpoint saved and restored byte for byte.
    The launch counts are set to 0 before training and read after the eval
    pass and the last_only forward, which launch B3; the train steps launch
    nothing. -> those counts."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models.layers import plain_attention
    from repro_torch.training.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig, adamw_update, decay_mask
    from repro_torch.training.trainer import (make_eval_step, make_loss_fn,
                                              make_train_step, to_device, value_and_grad)
    from repro_torch.tree import tree_leaves
    cfg = get_config(TRAIN_ARCH)
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
           cfg.vocab_size) == TRAIN_WANT, f"{TRAIN_ARCH} is not full width: {cfg}")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, params, opt, hist = train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                                     seq=TRAIN_SEQ, device=dev, log_every=10)
    wall = time.perf_counter() - t0
    check(sum(read_counts().values()) == 0, f"a kernel launched in a train step: "
                                            f"{read_counts()}")
    losses = hist["loss"]
    check(np.isfinite(losses).all() and np.isfinite(hist["grad_norm"]).all(),
          "non-finite loss or grad norm")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last < first, f"the loss did not fall: {first:.4f} -> {last:.4f}")
    step_ms = statistics.median(hist["ms"][10:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"train {TRAIN_ARCH}: {n_params / 1e6:.1f}M params, {TRAIN_STEPS} steps of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} in {wall:.1f} s; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (mean of the first 5 {first:.4f}, of the last 5 {last:.4f}); "
          f"{step_ms:.2f} ms a step (CUDA events, median of steps 11-{TRAIN_STEPS}; first "
          f"step {hist['ms'][0]:.1f} ms), {tokens / step_ms * 1e3:.0f} tokens/s; peak "
          f"device memory {peak:.2f} GiB")
    g = torch.Generator(device=dev).manual_seed(1)
    shape = (TRAIN_BATCH, TRAIN_SEQ, cfg.num_heads, cfg.head_dim)
    q, k, v, cot = (torch.randn(shape, generator=g, device=dev) for _ in range(4))
    for t in (q, k, v):
        t.requires_grad_()
    attn_ms = cuda_ms(lambda: torch.autograd.grad(plain_attention(q, k, v), (q, k, v), cot))
    print(f"train {TRAIN_ARCH}: attention core (plain, causal) forward + backward at "
          f"{shape}: {attn_ms:.4f} ms a layer, {cfg.num_layers * attn_ms:.3f} ms a step "
          f"= {cfg.num_layers * attn_ms / step_ms * 100:.1f}% of the step")
    del q, k, v, cot
    # the step's parts, each timed alone on the trained state and batch 51
    batch = to_device(SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
                      .batch(TRAIN_STEPS + 1), dev)
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=TRAIN_STEPS)
    loss_fn, mask = make_loss_fn(model), decay_mask(cfg, params)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: loss_fn(params, batch), windows=5, inner=1)
    fb_ms = cuda_ms(lambda: value_and_grad(loss_fn, params, batch), windows=5, inner=1)
    grads = value_and_grad(loss_fn, params, batch)[2]
    upd_ms = cuda_ms(lambda: adamw_update(opt_cfg, grads, opt, params, mask),
                     windows=5, inner=1)
    del grads
    print(f"train {TRAIN_ARCH}: a step's parts alone: forward {fwd_ms:.2f} ms (no grad), "
          f"forward + backward {fb_ms:.2f} ms, AdamW update {upd_ms:.2f} ms over "
          f"{len(tree_leaves(params))} leaves ({fb_ms / step_ms * 100:.1f}% and "
          f"{upd_ms / step_ms * 100:.1f}% of the {step_ms:.2f} ms step)")

    ev = make_eval_step(model)(params, batch)
    with torch.no_grad():
        ref_total, _ = make_loss_fn(model)(params, batch)
        full, _ = model.forward(params, batch["tokens"], differentiable=True)
        last_logits, _ = model.forward(params, batch["tokens"], last_only=True)
    rel = abs(float(ev["total"]) - float(ref_total)) / abs(float(ref_total))
    check(rel <= 1e-5, f"eval loss through B3 {float(ev['total'])} vs the differentiable "
                       f"route {float(ref_total)}")
    last_err = float((last_logits[:, 0] - full[:, -1]).abs().max())
    check(last_err <= 1e-4, f"last_only logits {last_err:.3g} from the full pass")
    counts = read_counts()
    check(counts["prefill_attention"] > 0, f"B3 was not launched in training's eval: {counts}")
    eval_ms = cuda_ms(lambda: make_eval_step(model)(params, batch), windows=5, inner=1)
    with torch.no_grad():
        plain_ms = cuda_ms(lambda: make_loss_fn(model)(params, batch), windows=5, inner=1)
    print(f"train {TRAIN_ARCH}: eval loss through B3 {float(ev['total']):.6f}, through the "
          f"differentiable route {float(ref_total):.6f} ({rel:.2e} relative); last_only "
          f"logits {last_err:.2e} from the full pass; eval pass {eval_ms:.2f} ms (B3) vs "
          f"{plain_ms:.2f} ms (plain attention)")
    del full, last_logits

    batch = to_device(SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
                      .batch(TRAIN_STEPS + 2), dev)
    p1, s1, m1 = make_train_step(model, opt_cfg)(params, opt, batch)
    p2, _, m2 = make_train_step(model, opt_cfg, num_microbatches=2)(params, opt, batch)
    for key in ("loss", "grad_norm"):
        a, b = float(m1[key]), float(m2[key])
        check(abs(a - b) <= STEP_TOL * (1 + abs(a)), f"microbatches: {key} {a} vs {b}")
    worst = params_close(p1, p2, s1.mu, float(m1["lr"]), "2 microbatches")
    print(f"train {TRAIN_ARCH}: 2 microbatches vs 1: loss {float(m2['loss']):.6f} vs "
          f"{float(m1['loss']):.6f}, grad norm {float(m2['grad_norm']):.6f} vs "
          f"{float(m1['grad_norm']):.6f}, params {worst:.2e} apart")
    del p1, s1, p2
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as d:
        t = time.perf_counter()
        save_checkpoint(d, TRAIN_STEPS, cfg, params, opt)
        t_save = time.perf_counter() - t
        t = time.perf_counter()
        p_back, o_back, manifest = restore_checkpoint(d, TRAIN_STEPS, cfg, device=dev)
        t_load = time.perf_counter() - t
    a, b = tree_leaves((params, opt)), tree_leaves((p_back, o_back))
    check(len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y)
                                   for x, y in zip(a, b)),
          "a restored checkpoint differs from what was saved")
    print(f"train {TRAIN_ARCH}: checkpoint of {manifest['n_arrays']} arrays, "
          f"{manifest['bytes'] / 2**30:.2f} GiB, saved in {t_save:.1f} s and restored in "
          f"{t_load:.1f} s, byte for byte")
    print(f"train {TRAIN_ARCH}: launches {({n: c for n, c in counts.items() if c})}")
    return counts


# ---------------------------------------------------------------------------------
# phase 6: the dry-run group on the card
# ---------------------------------------------------------------------------------
DRY_ARCH, DRY_SHAPE = "llama3.2-1b", "long_500k"
DRY_WANT = (16, 2048, 32, 8, 64, 128256, True)  # layers, d_model, heads, KV, hd, vocab, tied
DRY_STEPS = 8
DRY_POS = 524_287               # long_500k's last position: every row's cache_len is W
DRY_TOL = 1e-5                  # stacked against flat logits, max abs


def _decode_run(step, params, state, token, label: str):
    """DRY_STEPS greedy steps of ``step`` after one untimed step from the
    same state (warm-up, outside the counts) -> (logits of each step,
    tokens, ms of each step (CUDA events), peak device memory GiB, launch
    counts)."""
    with torch.no_grad():
        step(params, state, token, DRY_POS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    logits, toks, ms = [], [], []
    with torch.no_grad():
        for i in range(DRY_STEPS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out, state = step(params, state, token, DRY_POS + i)
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
            token = out.argmax(-1).to(torch.int32)
            logits.append(out)
            toks.append(int(token[0]))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{label}: {DRY_STEPS} steps at pos {DRY_POS}.., {statistics.median(ms):.3f} ms a "
          f"step (median; first {ms[0]:.3f}; CUDA events), peak device memory {peak:.2f} GiB, "
          f"B2 launches {counts['decode_attention']}")
    return logits, toks, ms, peak, counts


def _dtensor_decode_run(model, params, state, token, mesh):
    """The stacked decode step with params, state and token distributed
    over ``mesh`` by the dry-run's specs: one untimed step under the
    collective census (outside the counts), then DRY_STEPS greedy steps
    timed with CUDA events -> (logits of each step, rank 0's local shards;
    ms of each step; launch counts; the census)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed.sharding import data_specs, param_specs, state_specs
    from repro_torch.launch.dryrun import StepCensus, collective_census, distribute
    specs = (param_specs(params, mesh), state_specs(state, mesh, 1, kv_shard="window"),
             data_specs({"t": token}, mesh)["t"])
    dparams, dstate, dtoken = distribute((params, state, token), specs, mesh)
    census = StepCensus((dparams, dstate, dtoken))
    logits, ms = [], []
    with torch.no_grad(), implicit_replication():
        with census:
            model.decode_step_stacked(dparams, dstate, dtoken, DRY_POS)
        torch.cuda.synchronize()
        reset_counts()
        for i in range(DRY_STEPS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out, dstate = model.decode_step_stacked(dparams, dstate, dtoken, DRY_POS + i)
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
            dtoken = out.argmax(-1).to(torch.int32)
            logits.append(out.to_local())
    return logits, ms, read_counts(), collective_census(census.records)


def check_dryrun_group(dev, report: dict) -> dict:
    """Phase 6: ``decode_step_stacked`` at long_500k's shape on full-width
    llama3.2-1b (B = 1, W = 16,384) against ``decode_step`` on the same
    state; the 1 x 1-mesh dry-run's argument bytes against the allocator;
    the same stacked step as DTensors on the 1 x 1 CUDA mesh against the
    plain one (its census all zero), and the record's argument + temp +
    output bytes against the allocator's peak over one plain step;
    ``lower_sharded_retrieval``'s 4-shard search against the unsharded B1;
    then B2 at this shape against its plain version and SDPA (outside the
    path's counts). -> the path's launch counts."""
    from repro_torch.configs import LONG_CONTEXT_WINDOW, get_config
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels.dense_topk import dense_topk, dense_topk_plain
    from repro_torch.launch.dryrun import dryrun_pair
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import build_model
    from repro_torch.retrieval.sharded import lower_sharded_retrieval, sharded_dense_topk
    from repro_torch.tree import tree_leaves
    cfg = get_config(DRY_ARCH)
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
           cfg.vocab_size, cfg.tie_embeddings) == DRY_WANT, f"{DRY_ARCH} is not as published")
    W = LONG_CONTEXT_WINDOW
    t0 = time.perf_counter()
    rec = dryrun_pair(DRY_ARCH, DRY_SHAPE, mesh=make_local_mesh(dev), dtype=torch.float32,
                      verbose=False)
    check(rec["ok"], f"dry-run {DRY_ARCH} x {DRY_SHAPE} on the 1x1 mesh: {rec['error']}")
    want = rec["memory"]["argument_bytes"]
    model = build_model(cfg)
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init(gen)
    state = model.init_decode_state_stacked(1, W, device=dev)
    token = torch.randint(cfg.vocab_size, (1,), generator=gen, device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    got = torch.cuda.memory_allocated(dev) - before
    rel = abs(got - want) / want
    check(rel <= 0.01, f"dry-run argument bytes {want} vs allocated {got}")
    print(f"dry-run {DRY_ARCH} x {DRY_SHAPE} on the 1x1 mesh (fp32): argument bytes {want} "
          f"({want / 2**30:.3f} GiB), the allocator's delta for the same params, stacked "
          f"state and token {got} (rel. difference {rel:.2e}); flops {rec['flops']:.4g} "
          f"(global); planned in {rec['seconds']:.2f} s")
    with torch.no_grad():
        for leaf in tree_leaves(state):
            leaf.normal_(generator=gen)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"{DRY_ARCH}: {n_params / 1e9:.3f}B params fp32; stacked k and v "
          f"{tuple(state['stages'][0]['k'].shape)} each from seed 0")

    # the path: both decodes over the same state, and the sharded search
    s_logits, s_toks, s_ms, s_peak, s_counts = _decode_run(
        model.decode_step_stacked, params, state, token, "decode_step_stacked")
    f_logits, f_toks, f_ms, f_peak, f_counts = _decode_run(
        model.decode_step, params, model.unstack_decode_state(state), token, "decode_step (flat)")
    err = max((a - b).abs().max().item() for a, b in zip(s_logits, f_logits))
    check(err <= DRY_TOL, f"stacked vs flat logits: max abs {err}")
    check(s_toks == f_toks, f"stacked tokens {s_toks} != flat {f_toks}")
    for label, c in (("stacked", s_counts), ("flat", f_counts)):
        check(c["decode_attention"] == cfg.num_layers * DRY_STEPS,
              f"{label}: B2 launched {c['decode_attention']} times")
    print(f"stacked == flat over {DRY_STEPS} greedy steps: tokens {s_toks}, max |dlogit| "
          f"{err:.3e}")

    # the stacked step as DTensors on the 1 x 1 CUDA mesh: B2 through local_map
    d_logits, d_ms, d_counts, census = _dtensor_decode_run(model, params, state, token,
                                                           make_local_mesh(dev))
    d_err = max((a - b).abs().max().item() for a, b in zip(d_logits, s_logits))
    check(d_err <= DRY_TOL, f"DTensor vs plain stacked logits: max abs {d_err}")
    check(d_counts["decode_attention"] == cfg.num_layers * DRY_STEPS,
          f"DTensor step: B2 launched {d_counts['decode_attention']} times")
    check(census["total_bytes"] == 0 and all(census[k]["count"] == 0 for k in census
                                             if k != "total_bytes"),
          f"DTensor step on the 1 x 1 mesh issued collectives: {census}")
    print(f"decode_step_stacked as DTensors on the 1x1 {dev} mesh: {DRY_STEPS} steps, "
          f"{statistics.median(d_ms):.3f} ms a step (median; plain stacked "
          f"{statistics.median(s_ms):.3f}; the difference is DTensor's host dispatch), "
          f"max |dlogit| vs plain {d_err:.3e}, B2 launches {d_counts['decode_attention']}, "
          f"collective bytes {census['total_bytes']}")

    # the record's memory against the allocator over one plain stacked step
    del d_logits
    gc.collect()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        out = model.decode_step_stacked(params, state, token, DRY_POS)
    torch.cuda.synchronize()
    peak = got + torch.cuda.max_memory_allocated(dev) - m0
    del out
    mem = rec["memory"]
    planned = mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]
    mem_rel = abs(planned - peak) / peak
    check(mem_rel <= 0.10, f"dry-run argument + temp + output bytes {planned} vs the "
                           f"allocator's peak {peak}")
    print(f"dry-run memory (1x1 mesh, meta): argument {mem['argument_bytes']} + temp "
          f"{mem['temp_bytes']} + output {mem['output_bytes']} = {planned} bytes; the "
          f"allocator's peak over one plain stacked step, the arguments included, {peak} "
          f"(rel. difference {mem_rel:.2e})")
    del s_logits, f_logits, params, state
    gc.collect()
    torch.cuda.empty_cache()

    plan = lower_sharded_retrieval(4, device=dev)
    N, d, B, k = plan["bounds"][-1][1], plan["d"], plan["batch"], plan["k"]
    kb = unit_rows(gen, N, d, dev)
    q = unit_rows(gen, B, d, dev)
    check(sum(plan["shard_bytes"]) == kb.numel() * 4, "shard bytes")
    shards = [kb[lo:hi] for lo, hi in plan["bounds"]]
    reset_counts()
    s_sh, i_sh = sharded_dense_topk(q, shards, k, n_total=N)
    torch.cuda.synchronize()
    sh_counts = read_counts()
    check(sh_counts["dense_topk"] == 4, f"4-shard search: {sh_counts['dense_topk']} launches")
    s_one, i_one = dense_topk(q, kb, k)
    check(torch.equal(s_sh, s_one) and torch.equal(i_sh, i_one.long()),
          "4-shard search differs from the unsharded B1")
    # B1 at this d and B against its plain version, as phase 3 holds it
    s_p, i_p = dense_topk_plain(q, kb, k + 1)
    b1_err, gap = compare_topk(f"B1 B={B} N={N} d={d} k={k}", s_one, i_one, s_p, i_p, k)
    report["dense_topk@lower_sharded"] = dict(
        max_abs_err=b1_err, rows_with_clear_gap=int(gap.sum()),
        shape=f"B={B} N={N} d={d} k={k}, 4 shards of {plan['shard_n']}")
    print(f"lower_sharded_retrieval(4): shard_n {plan['shard_n']}, k_local "
          f"{plan['k_local']}, {plan['shard_bytes'][0] / 2**20:.0f} MiB a shard on "
          f"{plan['devices'][0]}; one search over {B} queries (N = {N}, d = {d}, k = {k}) "
          f"== the unsharded B1 byte for byte, 1 launch a shard; unsharded B1 against "
          f"its plain version: max |dscore| {b1_err:.2e}, rows with a clear k-th gap "
          f"{int(gap.sum())}/{B}")
    del kb, shards
    counts = {n: s_counts[n] + f_counts[n] + d_counts[n] + sh_counts[n] for n in s_counts}

    # B2 at this shape, outside the path's counts
    saved = read_counts()
    q, kc, vc = decode_inputs(gen, 1, W, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, dev)
    lens = torch.tensor([W], dtype=torch.int32, device=dev)
    r = time_decode(DA, q, kc, vc, lens, gen)
    need = cfg.num_heads * -(-W // DA.CHUNK) * (cfg.head_dim + 2)
    check(DA._scratch[dev.index][5] >= need > DA.MIN_SCRATCH,
          f"B2 partials scratch {DA._scratch[dev.index][5]} < {need}")
    report["decode_attention@long_500k"] = r
    set_counts(saved)
    report["phase6"] = dict(
        argument_bytes=want, allocated_bytes=got, flops=rec["flops"],
        stacked_ms=s_ms, flat_ms=f_ms, stacked_peak_gib=s_peak, flat_peak_gib=f_peak,
        max_abs_dlogit=err, tokens=s_toks, dtensor_ms=d_ms, dtensor_max_abs_dlogit=d_err,
        dtensor_census=census, record_memory=mem, allocator_peak_bytes=peak,
        memory_rel_difference=mem_rel, plan=plan, seconds=time.perf_counter() - t0)
    print(f"phase 6: {time.perf_counter() - t0:.1f} s")
    return counts


def engine_checks(stack, prompts, dev) -> None:
    """Batch variance of the decode step, the cost of functional snapshots,
    and where a decode step and a re-prefill spend their time."""
    from repro_torch.serving.batched import BatchedServeEngine
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.tree import tree_map

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
    copy = cuda_ms(lambda: tree_map(lambda c: c.clone(), state), windows=5, inner=3)
    tok = torch.zeros((4,), dtype=torch.long, device=dev)
    with torch.no_grad():
        step = cuda_ms(lambda: stack.model.decode_step(stack.params, state, tok, pos),
                       windows=5, inner=3)
    print(f"snapshot copy: the B=4 W=512 decode state is {nbytes / 1e6:.1f} MB; copying it "
          f"takes {copy:.4f} ms; one full-width B=4 decode step takes {step:.4f} ms")

    # where a decode step and a re-prefill spend their time on the device
    toks = torch.as_tensor([list(docs[0]) + prompts[0][:96]], device=dev)
    work = {"B=4 decode step": (lambda: stack.model.decode_step(
                stack.params, state, tok, pos), step),
            f"B=1 re-prefill S={toks.shape[1]}": (lambda: stack.model.prefill(
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


def recall_at(k: int, recorded, fp32, quant) -> dict:
    """recall@k of the int8 backend against the fp32 one over the query
    batches the int8 paths served, split by EDR (full scan) and ADR (probe)."""
    hits = {"EDR": [], "ADR": []}
    for queries, cand in recorded:
        if cand is None:
            want, got = fp32.search(queries, k)[0], quant.search(queries, k)[0]
        else:
            want = fp32.search_gathered(queries, cand, k)[0]
            got = quant.search_gathered(queries, cand, k)[0]
        for w, g in zip(want, got):
            ref = set(int(i) for i in w if i >= 0)
            hits["EDR" if cand is None else "ADR"].append(
                len(ref & set(int(i) for i in g if i >= 0)) / max(len(ref), 1))
    return {n: (float(np.mean(h)), len(h)) for n, h in hits.items()}


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--src", help="run phases 1-3 only, with the src/ directory of "
                                      "this or another tree (e.g. an unpacked parent commit)")
    parser.add_argument("--walls", action="store_true",
                        help="only the serving walls of phase 4's EDR kernel path and "
                             "the MoE family path, and phase 5's knnlm-247m step time "
                             "(with --src: for that tree)")
    parser.add_argument("--across-cards", action="store_true",
                        help="only build and check the sharded backends with their shards "
                             "over every visible card (needs more than one)")
    args = parser.parse_args(argv)
    global T0
    T0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    if args.src:
        sys.path.insert(0, str(Path(args.src).resolve()))
    import repro_torch  # noqa: F401  (switches TF32 off)
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import build_stack
    from repro_torch.retrieval.retrievers import ExactDenseRetriever, RetrieverStats
    from repro_torch.training.data import make_queries
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | torch "
          f"{torch.__version__} CUDA {torch.version.cuda} | tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}/{torch.backends.cudnn.allow_tf32}")
    t = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {len(logs)} sources in {time.perf_counter() - t:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    print(f"kernels of {Path(repro_torch.__file__).resolve().parents[1]}")
    if args.across_cards:
        check(torch.cuda.device_count() > 1, "--across-cards needs more than one card")
        check_sharded_across_cards()
        print(f"chip_smoke --across-cards: {time.perf_counter() - T0:.1f} s in all")
        print(smi)
        return 0

    if args.walls:
        stack, _, _ = build_serving(dev)
        prompts = [(q * 12)[:48] for q in make_queries(stack.docs, 8)]
        serve_path(stack, prompts, "EDR kernel", ("dense_topk", "decode_attention",
                                                   "prefill_attention"))
        stack.params, stack.engine = None, None
        gc.collect()
        torch.cuda.empty_cache()
        arch, want = FAMILY_PATHS[0]
        serve_family(arch, want, stack, prompts[:FAMILY_PROMPTS], dev)
        gc.collect()
        torch.cuda.empty_cache()
        train_full(dev)
        print(f"chip_smoke --walls: {time.perf_counter() - T0:.1f} s in all")
        print(smi)
        return 0

    # phase 3: every kernel against its plain version
    report: dict = {}
    reset_counts()
    check_dense_topk(dev, SERVE_N_DOCS, SERVE_ENC_DIM, report)
    check_decode_attention(dev, report)
    check_prefill_attention(dev, report)
    if takes_any_head_dim():
        check_head_dims(dev, report)
    if takes_wide_heads():
        check_wide_heads(dev, report)
    check_encoder_prefill(dev, report)
    stack, ivf, qb = build_serving(dev)
    prompts = [(q * 12)[:48] for q in make_queries(stack.docs, 64)]
    queries = stack.encoder.encode_batch(prompts)       # what RaLMSeq asks first
    fp32 = stack.retriever.backend
    # the tensors the serving paths scan: the fp32 KB, the int8 codes and scales
    check_gathered(dev, fp32._kb, qb._codes, qb._scales, ivf, queries[:12], report)
    check_quant_topk(dev, qb._codes, qb._scales, queries, report)
    if takes_any_d_and_k():
        check_any_d(dev)
    if importlib.util.find_spec("repro_torch.retrieval.sharded") is not None:
        check_sharded(dev, stack.retriever.kb.embeddings, fp32, qb, ivf, queries, report)
    check_counts = read_counts()
    if args.src:
        print(json.dumps({"phase3": report}))
        print(smi)
        return 0
    torch.cuda.empty_cache()

    # phase 4: the serving paths, each with its own launch counts
    prompts = prompts[:8]
    torch.cuda.reset_peak_memory_stats()
    paths = {}
    want = {}                                 # each unsharded path's RaLMSeq tokens
    paths["EDR kernel"], want["EDR kernel"], _ = serve_path(
        stack, prompts, "EDR kernel", ("dense_topk", "decode_attention", "prefill_attention"))
    seq_tokens = want["EDR kernel"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"EDR kernel: peak device memory {peak:.2f} GiB")
    adr = dataclasses.replace(stack, retriever=ivf, retriever_kind="adr", engine=None)
    paths["ADR kernel"], want["ADR kernel"], _ = serve_path(adr, prompts, "ADR kernel",
                                                            ("fused_gathered_topk",))
    rec = RecordingBackend(qb)
    qedr = dataclasses.replace(stack, retriever=ExactDenseRetriever(stack.retriever.kb,
                                                                    backend=rec),
                               backend="int8-kernel", engine=None)
    paths["EDR int8-kernel"], want["EDR int8-kernel"], _ = serve_path(
        qedr, prompts[:4], "EDR int8-kernel", ("quant_dense_topk",))
    qivf = copy.copy(ivf)                             # the same index, int8 backend
    qivf.backend, qivf.stats = rec, RetrieverStats("linear_intercept")
    qadr = dataclasses.replace(adr, retriever=qivf, backend="int8-kernel", engine=None)
    paths["ADR int8-kernel"], want["ADR int8-kernel"], _ = serve_path(
        qadr, prompts[:4], "ADR int8-kernel", ("quant_fused_gathered_topk",))
    paths["EDR kernel, faults"] = serve_faults(stack, prompts[:4], seq_tokens[:4],
                                               "EDR kernel, faults")
    recall = recall_at(20, rec.asked, fp32, qb)
    print("recall@20 of int8-kernel against kernel over the served query rows: " +
          ", ".join(f"{n} {r:.4f} ({m} rows)" for n, (r, m) in recall.items()))
    del rec, qedr, qivf, qadr, qb
    # the sharded backends: --mesh-shards 4 over the same KB, freed after
    paths.update(serve_sharded(stack, ivf, prompts, want, dev))
    t0 = time.perf_counter()
    sr = build_stack("sr", n_docs=SR_N_DOCS, full_width=True, device=dev, rcfg=stack.rcfg)
    print(f"SR stack: BM25 over {sr.retriever.kb.size} passages (terms "
          f"{sr.retriever.kb.terms.shape}); built in {time.perf_counter() - t0:.1f} s")
    sr_prompts = [(q * 12)[:48] for q in make_queries(sr.docs, 4)]
    paths["SR numpy"], _, _ = serve_path(sr, sr_prompts, "SR numpy",
                                         ("decode_attention", "prefill_attention"))
    del sr
    torch.cuda.empty_cache()

    # KNN-LM: knnlm-247m over the 1M x 1024 datastore
    knn, knn_ivf = build_knnlm(dev)
    knn_prompts = [knn.stream[i * 97:i * 97 + 48].tolist() for i in range(8)]
    knn_rec = RecordingBackend(knn.retriever.backend)   # the merged batches, for B1 below
    knn.retriever.backend = knn_rec
    paths["KNN-LM EDR kernel"], knn_tokens, _ = serve_path(
        knn, knn_prompts, "KNN-LM EDR kernel",
        ("dense_topk", "decode_attention", "prefill_attention"))
    knn.retriever.backend = knn_rec.inner
    knn_adr = dataclasses.replace(knn, retriever=knn_ivf, retriever_kind="adr", engine=None)
    paths["KNN-LM ADR kernel"], _, _ = serve_path(
        knn_adr, knn_prompts, "KNN-LM ADR kernel", ("fused_gathered_topk",))
    paths["KNN-LM EDR continuous"] = serve_continuous(knn, knn_prompts, knn_tokens,
                                                      "KNN-LM EDR kernel")
    check_datastore_topk(dev, knn.retriever.backend._kb, knn_rec.asked, report)
    del knn, knn_rec, knn_adr, knn_ivf

    # the MoE, SSM, VLM and audio families at full width over the same KB; the
    # ralm-gpt2-medium weights and engines and the KNN-LM stack are freed
    # first (the KB, the docs and the encoder stay), and the gpt2 weights
    # are drawn again from the same seed for the engine checks after
    del adr, ivf
    stack.params, stack.engine = None, None
    gc.collect()
    torch.cuda.empty_cache()
    for arch, want in FAMILY_PATHS:
        paths[arch] = serve_family(arch, want, stack, prompts[:FAMILY_PROMPTS], dev)
        gc.collect()
        torch.cuda.empty_cache()
    # phase 5: training, the reduced families card against CPU, then knnlm-247m
    check_train_reduced(dev)
    paths["train " + TRAIN_ARCH] = train_full(dev)
    gc.collect()
    torch.cuda.empty_cache()
    # phase 6: the dry-run group, the stacked decode at long_500k's window
    paths["phase 6 " + DRY_ARCH] = check_dryrun_group(dev, report)
    gc.collect()
    torch.cuda.empty_cache()
    counts = {n: sum(c[n] for c in paths.values()) for n in check_counts}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    stack.params = stack.model.init(gen)
    # last: host dispatch stays slower after torch.profiler has run
    engine_checks(stack, prompts, dev)

    src = "src/repro_torch/kernels/csrc/"
    sources = {"dense_topk": ("dense_topk.cu", "dense_topk.py:188"),
               "decode_attention": ("decode_attention.cu", "decode_attention.py:66"),
               "prefill_attention": ("prefill_attention.cu", "prefill_attention.py:90"),
               "fused_gathered_topk": ("gathered_topk.cu", "dense_topk.py:460"),
               "gathered_topk": ("gathered_topk.cu", "dense_topk.py:145"),
               "quant_dense_topk": ("dense_topk.cu", "dense_topk.py:295"),
               "quant_fused_gathered_topk": ("gathered_topk.cu", "dense_topk.py:578"),
               "quant_gathered_topk": ("gathered_topk.cu", "dense_topk.py:340")}
    kernels = []
    for name, (cu, replaces) in sources.items():
        r = report[name]
        # ms and library_ms are per-call times through the wrapper (host
        # dispatch included), as call_ms; *device_ms are CUDA-graph replays
        entry = {"name": name, "route": "cuda", "source": src + cu,
                 "replaces": "src/repro/kernels/" + replaces, "launches": counts[name],
                 "max_abs_err": r["max_abs_err"], "ms": r["call_ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": r["library_call_ms"],
                 "device_ms": r["device_ms"], "call_ms": r["call_ms"],
                 "library_device_ms": r["library_device_ms"],
                 "library_call_ms": r["library_call_ms"],
                 "library_call": LIBRARY_CALLS[name], "shape": r["shape"]}
        if "cold_device_ms" in r:        # B2: device time with a cold L2
            entry["cold_device_ms"] = r["cold_device_ms"]
        if f"{name}@B=1" in report:      # B2 and the gathered scans at RaLMSeq's B=1
            entry["at_B1"] = report[f"{name}@B=1"]
        if f"{name}@datastore" in report:    # B1 over the KNN-LM datastore
            entry["at_datastore"] = report[f"{name}@datastore"]
        if f"{name}@hd256" in report:        # B2 and B3 at paligemma-3b's shapes
            entry["at_hd256"] = report[f"{name}@hd256"]
        if f"{name}@long_500k" in report:    # B2 at the dry-run's long-context window
            entry["at_long_500k"] = report[f"{name}@long_500k"]
        if f"{name}@hd512" in report:        # B2 and B3 through the wide-head kernels
            entry["at_hd512"] = report[f"{name}@hd512"]
        if f"{name}@encoder" in report:      # B3 at whisper-base's encoder
            entry["at_encoder"] = report[f"{name}@encoder"]
        if f"{name}@4shards" in report:      # B1 as the sharded backend's per-shard scan
            entry["at_4shards"] = report[f"{name}@4shards"]
        if f"{name}@lower_sharded" in report:    # B1 at lower_sharded_retrieval's search
            entry["at_lower_sharded"] = report[f"{name}@lower_sharded"]
        if name in ("gathered_topk", "quant_gathered_topk"):
            # no serving route in either package: its launches are phase 3's
            entry["launches"] = check_counts[name]
            entry["launches_from"] = "phase 3 checks (no serving route in either package)"
        kernels.append(entry)
    print(json.dumps({"phase6": report["phase6"]}))
    print(json.dumps({"kernels": kernels}))
    print(f"chip_smoke: {time.perf_counter() - T0:.1f} s in all")
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
