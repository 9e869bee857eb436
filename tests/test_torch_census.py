"""The dry-run's collective census and memory accounting
(``repro_torch.launch.dryrun``), the activation constraints they rest on
(``distributed.mesh_ops.shard``, the masked ring write), and the engines'
``warm``.

* ``collective_census`` on hand-built DTensor programs on the 16 x 16 mesh;
* every reduced ``ASSIGNED_ARCHS`` config's decode and prefill steps on the
  1 x 1 mesh: the census is all zero, and with real CPU tensors the DTensor
  decode, prefill and forward equal the plain-tensor runs exactly (``shard``
  and the mesh routes change no arithmetic);
* a reduced train step of three families on both production meshes;
* the masked ring write, which a mesh with an axis of more than one device
  selects, against the reference's ``apply_self_attention_decode`` from
  converted parameters;
* the wrappers' mesh route on each rank's shards (``local_map``);
* the record's global FLOPs equal the plain step's count, and
  ``flops_per_device == flops / N`` on a data-only mesh;
* greedy pricing of DTensor's strategies against its graph search, on
  both production meshes;
* the record's keys against the reference record's, read from its source;
* ``warm`` leaves the engines' tokens and snapshots as they were.

The meshes are ``DeviceMesh``es over the fake process group of 512 ranks
(``launch.mesh``), global to the process: the module's fixture destroys it
after the last test, so no other test file on the worker sees it.
"""
import ast
import math
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import ASSIGNED_ARCHS, get_config, reduced
from repro_torch.distributed.sharding import data_specs, param_specs, state_specs
from repro_torch.launch import mesh as TM
from repro_torch.launch.dryrun import (COLLECTIVES, StepCensus, collective_census,
                                       dryrun_pair, run_distributed)
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_reference
from repro_torch.models.model import build_model
from repro_torch.serving.batched import BatchedServeEngine
from repro_torch.serving.engine import ServeEngine
from repro_torch.tree import tree_leaves

# six xdist workers share the host's cores: one torch thread each
torch.set_num_threads(1)

REF_DRYRUN = os.path.join(os.path.dirname(__file__), "..", "src", "repro", "launch",
                          "dryrun.py")


@pytest.fixture(scope="module")
def meshes():
    """The 16 x 16 production mesh and the 1 x 1 local mesh, and the fake
    group torn down after."""
    yield {"16x16": TM.make_production_mesh(), "1x1": TM.make_local_mesh()}
    dist.destroy_process_group()


def test_census_of_a_tensor_parallel_mlp(meshes):
    """x (32, 64) split over 'data' by rows; w1 (64, 256) split over
    'model' by columns, w2 (256, 64) by rows. h = x @ w1 is local (rows over
    data, columns over model); y = h @ w2 contracts the model-split dim, so
    each device holds a partial sum of its (32 / 16, 64) rows, and making y
    whole over 'model' is one all-reduce whose output is that local block:
    2 * 64 * 4 = 512 bytes. Nothing else moves."""
    mesh = meshes["16x16"]
    x = distribute_tensor(torch.empty(32, 64, device="meta"), mesh, [Shard(0), Replicate()])
    w1 = distribute_tensor(torch.empty(64, 256, device="meta"), mesh, [Replicate(), Shard(1)])
    w2 = distribute_tensor(torch.empty(256, 64, device="meta"), mesh, [Replicate(), Shard(0)])
    census = StepCensus((x, w1, w2))
    with census:
        y = ((x @ w1) @ w2).redistribute(mesh, [Shard(0), Replicate()])
    assert tuple(y.to_local().shape) == (2, 64)
    got = collective_census(census.records)
    assert got["all-reduce"] == {"count": 1, "bytes": 512}
    assert got["total_bytes"] == 512
    assert all(got[k]["count"] == 0 for k in COLLECTIVES if k != "all-reduce")
    # global FLOPs of the two products, and one device's: rows / 16, columns / 16
    assert census.flops == 2 * 32 * 64 * 256 * 2
    assert census.flops_per_device == census.flops // 256


def test_census_of_an_all_gathered_weight(meshes):
    """w (256, 64) fp32 split by rows over 'data' and whole over 'model':
    each device holds 16 rows; making it whole is one all-gather over
    'data' whose output is the whole weight, 256 * 64 * 4 = 65,536 bytes."""
    mesh = meshes["16x16"]
    w = distribute_tensor(torch.empty(256, 64, device="meta"), mesh, [Shard(0), Replicate()])
    census = StepCensus((w,))
    with census:
        full = w.redistribute(mesh, [Replicate(), Replicate()])
    assert tuple(full.to_local().shape) == (256, 64)
    got = collective_census(census.records)
    assert got["all-gather"] == {"count": 1, "bytes": 65_536}
    assert got["total_bytes"] == 65_536
    assert census.output_bytes(full) == 65_536


def _steps(model, cfg):
    """(decode step, prefill step, forward) of a reduced model on CPU
    tensors, each under no_grad, with their arguments."""
    B, S, W = 2, 12, 16
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init(gen)
    extra = {}
    if cfg.family == "audio":
        extra["frames"] = torch.randn((B, cfg.encoder_frames, cfg.d_model), generator=gen)
    if cfg.family == "vlm":
        extra["patches"] = torch.randn((B, cfg.vision_patches, cfg.d_model), generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    state = model.init_decode_state_stacked(B, W)
    for leaf in tree_leaves(state):
        leaf.normal_(generator=gen)
    token = torch.randint(0, cfg.vocab_size, (B,), generator=gen)

    def decode(p, st, tok, pos):
        with torch.no_grad():
            return model.decode_step_stacked(p, st, tok, pos)

    def prefill(p, toks, ex):
        with torch.no_grad():
            return model.forward(p, toks, extra=ex or None, last_only=True)[0]

    def forward(p, toks, ex):
        with torch.no_grad():
            return model.forward(p, toks, extra=ex or None)

    return params, ((decode, (params, state, token, W + 3)),
                    (prefill, (params, tokens, extra)),
                    (forward, (params, tokens, extra)))


def _specs(fn_name, args, mesh):
    if fn_name == "decode":
        params, state, token, _ = args
        return (param_specs(params, mesh), state_specs(state, mesh, token.shape[0],
                                                       kv_shard="window"),
                data_specs({"t": token}, mesh)["t"], None)
    params, tokens, extra = args
    return (param_specs(params, mesh), data_specs({"t": tokens}, mesh)["t"],
            data_specs(extra, mesh))


def _whole(tree):
    from torch.distributed.tensor import DTensor
    return [t.full_tensor() if isinstance(t, DTensor) else t for t in tree_leaves(tree)]


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_one_device_mesh_changes_nothing(meshes, arch):
    """On the 1 x 1 mesh, with real CPU tensors at reduced size, the decode
    step, the prefill step and the full forward as DTensors equal the
    plain-tensor runs exactly, outputs and new state alike, and issue no
    collective."""
    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    _, steps = _steps(model, cfg)
    for fn, args in steps:
        want = fn(*args)
        got, census = run_distributed(fn, args, _specs(fn.__name__, args, meshes["1x1"]),
                                      meshes["1x1"])
        for g, w in zip(_whole(got), tree_leaves(want)):
            assert torch.equal(g, w), (arch, fn.__name__)
        coll = collective_census(census.records)
        assert coll["total_bytes"] == 0 and not census.records, (arch, fn.__name__, coll)
        assert census.flops == census.flops_per_device > 0


def test_masked_ring_write_matches_reference(meshes):
    """A mesh with an axis of more than one device selects the reference's
    masked ring write (``mesh_ops.mesh_active``). Every tensor replicated on
    the 16 x 16 mesh (so each rank computes the whole step on real values):
    the masked write gives the reference's output and caches within 1e-6,
    for a write inside the ring and for one that wraps it."""
    import jax
    from repro.configs import get_config as ref_get_config
    from repro.configs import reduced as ref_reduced
    from repro.models import layers as RL
    from repro.models.model import Model as RefModel
    cfg = ref_reduced(ref_get_config("llama3.2-1b"), layers=2)
    tcfg = reduced(get_config("llama3.2-1b"), layers=2)
    ref = RefModel(cfg)
    tree = ref.init(jax.random.PRNGKey(0))
    params = params_from_reference(tcfg, jax.tree.map(np.asarray, tree))
    mp = params["layers"][1]["mixer"]
    rp = ref._layer_params(tree, 1)["mixer"]
    rng = np.random.default_rng(0)
    B, W = 2, 8
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    kc = rng.standard_normal((B, W, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)
    vc = rng.standard_normal(kc.shape).astype(np.float32)
    mesh = meshes["16x16"]
    rep = [Replicate(), Replicate()]
    for pos in (5, W + 3):
        write, lens = pos % W, np.full((B,), min(pos + 1, W), np.int32)
        want = RL.apply_self_attention_decode(rp, cfg, x, jax.numpy.int32(pos), kc, vc, lens,
                                              write)
        d = {k: distribute_tensor(v, mesh, rep) for k, v in mp.items()}
        args = [distribute_tensor(torch.from_numpy(a), mesh, rep) for a in (x, kc, vc)]
        assert L.mesh_active(args[1])
        with implicit_replication():     # the step's positions and masks are plain
            got = L.apply_self_attention_decode(d, tcfg, args[0], pos, args[1], args[2],
                                                torch.from_numpy(lens), write)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.to_local().numpy(), np.asarray(w), atol=1e-6, rtol=0)
        plain = L.apply_self_attention_decode(mp, tcfg, torch.from_numpy(x), pos,
                                              torch.from_numpy(kc), torch.from_numpy(vc),
                                              torch.from_numpy(lens), write)
        for g, w in zip(got, plain):
            np.testing.assert_allclose(g.to_local().numpy(), w.numpy(), atol=1e-6, rtol=0)


def _reduced_train_step(arch, mesh, microbatches):
    """(step, its meta arguments, their specs) for a train step of ``arch``
    reduced to 2 layers at d_model 256, a batch of 64 rows."""
    from repro_torch.launch.steps import _extra, meta_params
    from repro_torch.training.optimizer import AdamWConfig, init_adamw
    from repro_torch.training.trainer import make_train_step
    cfg = reduced(get_config(arch), layers=2, d_model=256)
    model = build_model(cfg)
    params = meta_params(model)
    B, S = 64, 256 - (cfg.vision_patches if cfg.family == "vlm" else 0)
    tokens = torch.empty((B, S), dtype=torch.int32, device="meta")
    batch = {"tokens": tokens, "labels": torch.empty_like(tokens),
             **_extra(cfg, B, torch.bfloat16)}
    opt = init_adamw(params)
    step = make_train_step(model, AdamWConfig(), remat=True, num_microbatches=microbatches)
    specs = (param_specs(params, mesh), param_specs(opt, mesh), data_specs(batch, mesh))
    return step, (params, opt, batch), specs


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "paligemma-3b", "whisper-base"])
def test_reduced_train_step_runs_on_the_production_meshes(meshes, arch, multi_pod):
    """A train step (2 microbatches, remat, AdamW) of a reduced config as
    DTensors on meta shards on 16 x 16 and 2 x 16 x 16: the backward
    passes the mesh routes (heads split where the mesh split cannot follow
    them, the gradient of the merge gathered as the forward's split was:
    ``mesh_ops.split_dim`` / ``merge_dims``), the census counts collectives
    and every device computes a share of the step."""
    mesh = TM.make_production_mesh(multi_pod=multi_pod)
    step, (params, opt, batch), specs = _reduced_train_step(arch, mesh, 2)
    (new_params, _, _), census = run_distributed(step, (params, opt, batch), specs, mesh)
    assert tree_leaves(new_params)[0].shape == tree_leaves(params)[0].shape
    assert collective_census(census.records)["total_bytes"] > 0
    assert 0 < census.flops_per_device < census.flops


def test_mesh_route_runs_the_kernel_on_each_ranks_shards(meshes, monkeypatch):
    """On CUDA shards a wrapper runs its kernel on each rank's shards through
    ``local_map``. Here the route is taken on CPU shards (``_build.on_cpu``
    answering False) with the plain version standing in for the kernel, on
    the 16 x 16 mesh: with the heads split over 'model' (32 query heads over
    16 KV heads, 2 and 1 a device), rank 0's output is the whole attention's
    first two heads, placed as q's heads are; a split window cannot be
    attended alone and raises, and so do heads that the mesh splits
    unevenly (12 query heads over 4 KV heads on 16 'model' devices: rank 0
    holds one of each, where a KV head serves 3 query heads)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as DA
    mesh = meshes["16x16"]
    g = torch.Generator()
    g.manual_seed(0)
    B, H, KV, hd, W = 2, 32, 16, 8, 12
    q = torch.randn((B, H, hd), generator=g)
    kc, vc = torch.randn((B, W, KV, hd), generator=g), torch.randn((B, W, KV, hd), generator=g)
    lens = torch.tensor([5, 12], dtype=torch.int32)
    calls = []

    def kernel(*a):
        calls.append(tuple(t.shape for t in a))
        return DA.decode_attention_plain(*a)

    monkeypatch.setattr(_build, "on_cpu", lambda what, *t: False)
    monkeypatch.setattr(DA, "_kernel", kernel)
    heads = [Replicate(), Shard(1)]
    dq = distribute_tensor(q, mesh, heads)
    dk, dv = (distribute_tensor(t, mesh, [Replicate(), Shard(2)]) for t in (kc, vc))
    out = DA.decode_attention(dq, dk, dv, lens)
    assert calls == [((B, 2, hd), (B, W, 1, hd), (B, W, 1, hd), (B,))]
    assert tuple(out.placements) == tuple(heads)
    want = DA.decode_attention_plain(q, kc, vc, lens)
    assert torch.equal(out.to_local(), want[:, :2])
    window = [Replicate(), Shard(1)]
    dk, dv = (distribute_tensor(t, mesh, window) for t in (kc, vc))
    with pytest.raises(ValueError, match="no kernel route"):
        DA.decode_attention(distribute_tensor(q, mesh, [Replicate()] * 2), dk, dv, lens)
    uneven = [distribute_tensor(t, mesh, p) for t, p in (
        (q[:, :12], heads), (kc[:, :, :4], [Replicate(), Shard(2)]),
        (vc[:, :, :4], [Replicate(), Shard(2)]))]
    with pytest.raises(ValueError, match="3 query heads a KV head"):
        DA.decode_attention(*uneven, lens)
    assert len(calls) == 1


def test_flops_per_device_divide_on_a_data_mesh(meshes):
    """llama3.2-1b's prefill_32k on an 8 x 1 (data, model) mesh: every
    product runs on one eighth of the batch's rows (32 sequences, 4 a
    device), so one device's FLOPs are the whole step's over 8, exactly."""
    mesh = TM._mesh("cpu", (8, 1), ("data", "model"))
    rec = dryrun_pair("llama3.2-1b", "prefill_32k", mesh=mesh, verbose=False)
    assert rec["ok"], rec.get("traceback")
    assert rec["mesh"] == "8x1"
    assert rec["flops_per_device"] * 8 == rec["flops"] > 0


@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k", "long_500k"])
def test_record_flops_equal_the_plain_count(meshes, shape_name):
    """The record's global FLOPs, counted on the DTensor ops of the
    distributed run, equal ``step_flops`` over the same step on plain meta
    tensors (which tests/test_torch_distributed.py holds to the analytic
    count): the census's redistributions and the masked ring write add no
    product."""
    from repro_torch.launch.dryrun import step_flops
    from repro_torch.launch.steps import make_step
    rec = dryrun_pair("llama3.2-1b", shape_name, mesh=meshes["16x16"], verbose=False)
    assert rec["ok"], rec.get("traceback")
    fn, args, _ = make_step("llama3.2-1b", shape_name, meshes["16x16"])
    assert rec["flops"] == step_flops(fn, args)
    assert 0 < rec["flops_per_device"] < rec["flops"]


@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k"])
def test_greedy_plans_give_the_graph_search_census(meshes, shape_name):
    """Greedy pricing of DTensor's candidate strategies (``_cpu_mesh``, the
    dry-run's faster option) against DTensor's own graph search (its
    default): on 16 x 16 both choose the
    same plan for llama3.2-1b's step, the same collectives, per-device
    FLOPs and live bytes. (For other configs they may choose differently,
    on either mesh: jamba-v0.1-52b's and qwen2-moe-a2.7b's steps did,
    which is why the dry-run prices by graph search unless asked; the
    redistributions run keep the graph search either way.)"""
    from repro_torch.launch.steps import make_step
    mesh = meshes["16x16"]
    fn, args, specs = make_step("llama3.2-1b", shape_name, mesh)
    runs = [run_distributed(fn, args, specs, mesh, pricing=p)[1]
            for p in ("greedy", "graph")]
    assert runs[0].records == runs[1].records and runs[0].records
    assert (runs[0].flops_per_device, runs[0].peak) == (runs[1].flops_per_device,
                                                       runs[1].peak)


def test_greedy_plans_give_the_graph_search_census_on_the_3d_mesh(meshes):
    """The same on 2 x 16 x 16, for a train step of llama3.2-1b reduced to
    2 layers at d_model 256 (one microbatch): at full size the graph search
    takes 4-27x as long as greedy pricing there, which the dry-run's tier-1
    test takes instead."""
    mesh = TM.make_production_mesh(multi_pod=True)
    step, args, specs = _reduced_train_step("llama3.2-1b", mesh, 1)
    runs = [run_distributed(step, args, specs, mesh, pricing=p)[1]
            for p in ("greedy", "graph")]
    assert runs[0].records == runs[1].records and runs[0].records
    assert (runs[0].flops_per_device, runs[0].peak) == (runs[1].flops_per_device,
                                                       runs[1].peak)


def _reference_record_keys():
    """(the reference's collective kinds, its record's memory fields), read
    from ``repro/launch/dryrun.py``'s source: importing it would fix the
    JAX host platform at 512 devices."""
    tree = ast.parse(open(REF_DRYRUN).read())
    kinds = memory = None
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "_COLLECTIVES"
                                                for t in node.targets):
            kinds = ast.literal_eval(node.value)
        if isinstance(node, ast.keyword) and node.arg == "memory":
            memory = [k.arg for k in node.value.keywords]
    return kinds, memory


def test_record_keys_match_reference(meshes):
    """The record has the reference's census (its five kinds, each {count,
    bytes}, and total_bytes) and its memory byte fields but the compiled
    code's size, which an eager run has none of; flops sit beside
    flops_per_device."""
    kinds, memory = _reference_record_keys()
    assert tuple(kinds) == COLLECTIVES
    rec = dryrun_pair("llama3.2-1b", "long_500k", mesh=meshes["16x16"], verbose=False)
    assert rec["ok"], rec.get("traceback")
    assert rec["pricing"] == "graph"            # DTensor's own planner
    assert set(rec["collectives"]) == set(kinds) | {"total_bytes"}
    assert all(set(rec["collectives"][k]) == {"count", "bytes"} for k in kinds)
    assert rec["collectives"]["total_bytes"] == sum(rec["collectives"][k]["bytes"]
                                                    for k in kinds) > 0
    byte_fields = [k for k in memory if k != "generated_code_bytes"]
    assert byte_fields == ["argument_bytes", "output_bytes", "temp_bytes"]
    assert set(byte_fields) <= set(rec["memory"])
    assert all(rec["memory"][k] > 0 for k in byte_fields)
    assert rec["flops_per_device"] < rec["flops"]
    # the long-context window split over (data, model): 16,384 / 256 ring
    # entries a device of each layer's k and v come back as new tensors
    cfg = get_config("llama3.2-1b")
    kv = 2 * cfg.num_layers * 16_384 // 256 * cfg.num_kv_heads * cfg.head_dim * 2
    assert rec["memory"]["output_bytes"] >= kv


@pytest.fixture(scope="module")
def engine_setup():
    cfg = reduced(get_config("llama3.2-1b"), layers=2)
    model = build_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init(gen)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, 20).tolist() for _ in range(2)]
    return model, params, prompts


def test_serve_engine_warm_changes_nothing(engine_setup):
    """``warm`` over a grid of lengths, between a request's start and its
    generation: the snapshot's tensors are the same objects after, the
    stats unchanged, and the tokens those of an engine never warmed."""
    model, params, prompts = engine_setup
    cold = ServeEngine(model, params, cache_window=64)
    cold.start(prompts[0])
    want = cold.gen(6)
    eng = ServeEngine(model, params, cache_window=64)
    eng.start(prompts[0])
    snap, stats = eng.snapshot(), vars(eng.stats).copy()
    eng.warm([8, 20, 33, 20])
    after = eng.snapshot()
    assert after[:2] == snap[:2] and after[3] == snap[3]
    assert after[2] is snap[2] and after[4] is snap[4]
    assert vars(eng.stats) == stats
    assert eng.gen(6) == want


def test_batched_engine_warm_changes_nothing(engine_setup):
    """As above for ``BatchedServeEngine``: the bundle the slots' snapshots
    hold is the live one after ``warm``, and both slots' tokens are those of
    an engine never warmed."""
    model, params, prompts = engine_setup

    def run(warm: bool):
        eng = BatchedServeEngine(model, params, 2, cache_window=64)
        for b, p in enumerate(prompts):
            eng.start(b, p)
        snap, stats = eng.snapshot(0), vars(eng.stats).copy()
        if warm:
            eng.warm([8, 21])
            assert all(a is b for a, b in zip(eng.snapshot(0)[2], snap[2]))
            assert vars(eng.stats) == stats
        eng.gen([0, 1], [6, 6])
        return [eng.generated(b) for b in range(2)]

    assert run(True) == run(False)
    assert math.prod(len(t) for t in run(True)) == 36
