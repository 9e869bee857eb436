"""The port's placement plans (``repro_torch.distributed.sharding``,
``launch.mesh``, ``launch.steps``, ``launch.dryrun``) held against the
reference's sharding rules.

* ``_sanitize`` on the reference's own cases;
* param specs for every config of the registry on both production meshes
  and three (fsdp, tp) settings: each port leaf's spec is the reference's
  spec of its counterpart, less the leading None where the reference stacks
  the leaf (the port's layers are unstacked);
* decode-state specs for every config at decode_32k and long_500k under the
  three KV placements, and batch specs with and without batch_over_model:
  equal to the reference's, leaf by leaf;
* one device's parameter bytes, from DTensor's local shards of the meta
  parameters, equal the reference's spec arithmetic (whole bytes divided by
  the product of the named axes' sizes) exactly, and for the four large
  configs stay within the reference's bound of total / 256;
* ``dryrun_pair`` in a subprocess, under a timeout each: xlstm-350m at
  long_500k and llama3.2-1b at every shape are ok on both meshes, and their
  per-device argument bytes equal the reference's spec arithmetic over the
  reference's ``make_step`` arguments (less the decode position: a 0-d
  array there, a host int here).
* the dry-run's flops for llama3.2-1b's prefill and decode pairs equal the
  analytic count of the step's matrix products.

The placement tests build ``DeviceMesh``es over a fake process group of 512
ranks in this process (``launch.mesh``); the module's fixture destroys the
group after its last test, so no other test file on the worker sees it.
"""
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh as RefMesh
from jax.sharding import PartitionSpec as P

from repro.configs import REGISTRY, SHAPES, get_config
from repro.configs import LONG_CONTEXT_WINDOW
from repro.distributed import sharding as RS
from repro.launch.steps import make_step as ref_make_step
from repro.models.model import build_model as ref_build_model
from repro.models.model import layer_plan
from repro_torch.configs import get_config as t_get_config
from repro_torch.distributed import sharding as TS
from repro_torch.launch import mesh as TM
from repro_torch.launch.dryrun import argument_bytes
from repro_torch.launch.steps import meta_params
from repro_torch.models.model import build_model
from repro_torch.tree import map_with_path, tree_leaves

# six xdist workers share the host's cores: one torch thread each
torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = sorted(REGISTRY)
MESHES = ("16x16", "2x16x16")
SIZES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16}}


@pytest.fixture(scope="module")
def meshes():
    """The port's production meshes, and the fake group torn down after."""
    yield {"16x16": TM.make_production_mesh(), "2x16x16": TM.make_production_mesh(multi_pod=True)}
    dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _ref_mesh(name):
    if name == "16x16":
        return RefMesh(np.array(jax.devices() * 256)[:256].reshape(16, 16), ("data", "model"))
    return RefMesh(np.array(jax.devices() * 512)[:512].reshape(2, 16, 16),
                   ("pod", "data", "model"))


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    model = ref_build_model(get_config(arch))
    return jax.eval_shape(lambda k: model.init(k, jnp.bfloat16), jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return meta_params(build_model(t_get_config(arch)), torch.bfloat16)


def _names(keypath):
    return tuple(str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", ""))))
                 for k in keypath)


def _ref_leaves(tree):
    """[(path names, leaf)] of a reference tree whose leaves may be specs."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))
    return [(_names(kp), leaf) for kp, leaf in flat]


def _port_leaves(tree):
    out = []
    map_with_path(lambda path, leaf: out.append((path, leaf)), tree, is_leaf=TS.is_spec)
    return out


def _ref_specs_in_port_layout(cfg, ref_specs):
    """{port leaf path: the reference spec of its counterpart}, less the
    stacked lead (the reference's ``blocks[j]`` hold layers n_pre + r *
    period + j along their first dim when the period repeats)."""
    n_pre, period, n_rep = layer_plan(cfg)
    out = {}
    for names, spec in _ref_leaves(ref_specs):
        want = tuple(spec)
        if names[0] == "prefix":
            out[("layers",) + names[1:]] = want
        elif names[0] == "blocks":
            for r in range(n_rep):
                i = n_pre + r * period + int(names[1])
                out[("layers", str(i)) + names[2:]] = want[1:] if n_rep > 1 else want
        else:
            out[names] = want
    return out


def _ref_bytes(pairs, sizes):
    """The reference's per-device arithmetic over (shape-dtype leaf, spec)."""
    total = 0
    for leaf, spec in pairs:
        div = 1
        for e in spec:
            for a in (() if e is None else e if isinstance(e, tuple) else (e,)):
                div *= sizes[a]
        total += int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize // div
    return total


@pytest.mark.parametrize("spec,shape,want", [
    (("model",), (8,), (None,)),                       # 8 % 16 != 0
    (("model",), (32,), ("model",)),
    ((("data", "model"),), (256,), (("data", "model"),)),
    (("pod",), (32,), (None,)),                        # axis absent
])
def test_sanitize_matches_reference(spec, shape, want):
    sizes = {"data": 16, "model": 16}
    got = TS._sanitize(TS.Spec(*spec), shape, sizes)
    assert got == tuple(RS._sanitize(P(*spec), shape, sizes)) == want
    assert isinstance(got, TS.Spec)


@pytest.mark.parametrize("fsdp,tp", [(True, True), (False, True), (False, False)])
@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(meshes, arch, mesh_name, fsdp, tp):
    ref = RS.param_specs(_ref_params(arch), _ref_mesh(mesh_name), fsdp=fsdp, tp=tp)
    got = TS.param_specs(_port_params(arch), meshes[mesh_name], fsdp=fsdp, tp=tp)
    want = _ref_specs_in_port_layout(get_config(arch), ref)
    assert dict(_port_leaves(got)) == want
    if not tp:
        assert all(e is None for _, s in _port_leaves(got) for e in s)


@functools.lru_cache(maxsize=None)
def _states(arch, shape_name):
    shape = SHAPES[shape_name]
    W = LONG_CONTEXT_WINDOW if shape.seq_len > 100_000 else shape.seq_len
    B = shape.global_batch
    ref = jax.eval_shape(lambda: ref_build_model(get_config(arch))
                         .init_decode_state_stacked(B, W, jnp.bfloat16))
    port = build_model(t_get_config(arch)).init_decode_state_stacked(
        B, W, device="meta", dtype=torch.bfloat16)
    return B, ref, port


@pytest.mark.parametrize("kv_shard", ["replicated", "head_dim", "window"])
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_state_specs_match_reference(meshes, arch, mesh_name, shape_name, kv_shard):
    B, ref_state, state = _states(arch, shape_name)
    ref = RS.state_specs(ref_state, _ref_mesh(mesh_name), B, kv_shard=kv_shard)
    got = TS.state_specs(state, meshes[mesh_name], B, kv_shard=kv_shard)
    assert {p: tuple(leaf.shape) for p, leaf in _port_leaves(state)} == \
        {p: tuple(leaf.shape) for p, leaf in _ref_leaves(ref_state)}
    assert dict(_port_leaves(got)) == {p: tuple(s) for p, s in _ref_leaves(ref)}


@pytest.mark.parametrize("batch_over_model", [False, True])
@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("shape_name", sorted(SHAPES))
def test_data_specs_match_reference(meshes, shape_name, mesh_name, batch_over_model):
    shape = SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    dims = {"tokens": (B, S), "labels": (B, S), "frames": (B, 1500, 512), "token": (B,)}
    ref = RS.data_specs({k: jax.ShapeDtypeStruct(v, jnp.int32) for k, v in dims.items()},
                        _ref_mesh(mesh_name), batch_over_model=batch_over_model)
    got = TS.data_specs({k: torch.empty(v, device="meta") for k, v in dims.items()},
                        meshes[mesh_name], batch_over_model=batch_over_model)
    assert {k: tuple(v) for k, v in ref.items()} == got


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_bytes_per_device_match_reference(meshes, arch, mesh_name):
    """DTensor's local shards of the port's meta params sum to the
    reference's per-device arithmetic; the four large configs stay near
    total / 256 on 16 x 16, as the reference's own test asks."""
    ref_params = _ref_params(arch)
    ref_specs = RS.param_specs(ref_params, _ref_mesh(mesh_name))
    want = _ref_bytes([(leaf, s) for (_, leaf), (_, s) in
                       zip(_ref_leaves(ref_params), _ref_leaves(ref_specs))], SIZES[mesh_name])
    params = _port_params(arch)
    got = argument_bytes(params, TS.param_specs(params, meshes[mesh_name]), meshes[mesh_name])
    assert got == want
    ratio = {"kimi-k2-1t-a32b": 1.05, "qwen1.5-110b": 1.05, "command-r-plus-104b": 1.05,
             "jamba-v0.1-52b": 1.10}.get(arch)
    if ratio and mesh_name == "16x16":
        total = sum(t.numel() * t.element_size() for t in tree_leaves(params))
        assert got <= total / 256 * ratio, (arch, got, total / 256)


def test_to_placements(meshes):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = meshes["2x16x16"]
    spec = TS.Spec(None, ("data", "model"), "pod")
    assert TS.to_placements(spec, mesh) == [Shard(2), Shard(1), Shard(1)]
    t = torch.empty((3, 512, 4), device="meta")
    assert distribute_tensor(t, mesh, TS.to_placements(spec, mesh)).to_local().shape == (3, 2, 2)
    assert TS.to_placements(TS.Spec(None), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="axis order"):
        TS.to_placements(TS.Spec(("model", "data")), mesh)


def _ref_argument_bytes(arch, shape_name, mesh_name):
    _, args, shardings = ref_make_step(arch, shape_name, _ref_mesh(mesh_name))
    if SHAPES[shape_name].kind == "decode":            # the position: a host int in the port
        args, shardings = args[:3], shardings[:3]
    leaves = jax.tree.leaves(args)
    specs = jax.tree.leaves(shardings, is_leaf=lambda x: hasattr(x, "spec"))
    assert len(leaves) == len(specs)
    return _ref_bytes([(a, s.spec) for a, s in zip(leaves, specs)], SIZES[mesh_name])


PAIRS = [("xlstm-350m", "long_500k")] + [("llama3.2-1b", s) for s in sorted(SHAPES)]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape_name", PAIRS)
def test_dryrun_pair_subprocess(arch, shape_name, multi_pod):
    # the train pair on 2 x 16 x 16 runs the plan's 8 microbatches
    # (steps.microbatches_for); on 16 x 16 it runs 2, not the plan's 16:
    # each is a forward and backward as DTensors (~10 s alone), 16 of them
    # would make this file the tier's longest by minutes, and the checks
    # below read nothing the count changes
    train = SHAPES[shape_name].kind == "train"
    kw = ", num_microbatches=2" if train and not multi_pod else ""
    # train and prefill on 2 x 16 x 16 price greedily here: DTensor's graph
    # search (the dry-run's default) takes 10-20 minutes there, and gives
    # these pairs the same records (PERF.md section 6);
    # tests/test_torch_census.py holds greedy pricing to the graph search
    greedy = multi_pod and SHAPES[shape_name].kind in ("train", "prefill")
    kw += f", pricing={'greedy' if greedy else 'graph'!r}"
    code = ("import json, torch; torch.set_num_threads(1);"
            "from repro_torch.launch.dryrun import dryrun_pair;"
            f"r = dryrun_pair({arch!r}, {shape_name!r}, multi_pod={multi_pod}, "
            f"verbose=False{kw});"
            "print('RECORD', json.dumps(r))")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("RECORD ")]
    assert lines, out.stdout + out.stderr
    rec = json.loads(lines[-1][len("RECORD "):])
    mesh_name = "2x16x16" if multi_pod else "16x16"
    assert rec["ok"], rec.get("traceback")
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["error"]) == (
        arch, shape_name, mesh_name, None)
    assert rec["pricing"] == ("greedy" if greedy else "graph")
    coll = rec["collectives"]
    assert set(coll) == {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                         "collective-permute", "total_bytes"}
    assert coll["total_bytes"] == sum(coll[k]["bytes"] for k in coll
                                      if k != "total_bytes") > 0
    assert rec["flops"] > 0
    assert rec["memory"]["argument_bytes"] == _ref_argument_bytes(arch, shape_name, mesh_name)


@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k", "long_500k"])
def test_dryrun_flops_match_the_analytic_count(meshes, shape_name):
    """llama3.2-1b's counted step equals the analytic count exactly: 2
    flops a multiply-add of each token's projections and FFN, of the
    unembedding of each logits row (prefill: the last position only), and
    of attention's two products over the whole (S, S) score matrix, masked
    entries included (prefill) or over the cache of T entries (decode)."""
    from repro_torch.launch.dryrun import step_flops
    from repro_torch.launch.steps import make_step
    cfg, shape = t_get_config("llama3.2-1b"), SHAPES[shape_name]
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    per_token = 2 * d * (H + 2 * KV) * hd + 2 * H * hd * d + 3 * 2 * d * cfg.d_ff
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "prefill":
        tokens, attn = B * S, 4 * B * S * S * H * hd
    else:
        T = LONG_CONTEXT_WINDOW if S > 100_000 else S
        tokens, attn = B, 4 * B * T * H * hd
    want = cfg.num_layers * (tokens * per_token + attn) + 2 * B * d * cfg.vocab_size
    fn, args, _ = make_step("llama3.2-1b", shape_name, meshes["16x16"])
    assert step_flops(fn, args) == want


def test_lower_sharded_retrieval_plans_the_search():
    """The reference's defaults over 4 shards, and a small plan whose shards,
    cut by its bounds, answer as the unsharded scan does byte for byte."""
    from repro_torch.kernels.dense_topk import dense_topk
    from repro_torch.retrieval.sharded import lower_sharded_retrieval, sharded_dense_topk
    plan = lower_sharded_retrieval(4, device="cpu")
    assert (plan["shard_n"], plan["k_local"], plan["devices"]) == (262_144, 20, ["cpu"] * 4)
    assert plan["bounds"] == [(s * 262_144, (s + 1) * 262_144) for s in range(4)]
    assert plan["shard_bytes"] == [262_144 * 256 * 4] * 4
    plan = lower_sharded_retrieval(3, n_docs=1001, d=6, batch=4, k=7, device="cpu")
    assert plan["shard_n"] == 334 and plan["shard_bytes"][-1] == 333 * 8 * 4
    rng = np.random.default_rng(0)
    kb = torch.from_numpy(rng.integers(-2, 3, (1001, 6)).astype(np.float32) / 2)
    q = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
    s, i = sharded_dense_topk(q, [kb[lo:hi] for lo, hi in plan["bounds"]], 7, n_total=1001)
    s0, i0 = dense_topk(q, kb, 7)
    assert torch.equal(s, s0) and torch.equal(i, i0.long())


def test_dryrun_main_writes_one_record_per_pair(meshes, tmp_path):
    """The CLI: one record per (mesh, arch, shape); a pair that fails is a
    record with ok false and its error, and the exit code is 1."""
    from repro_torch.launch.dryrun import main
    out = tmp_path / "dry.json"
    assert main(["--arch", "xlstm-350m", "--shape", "long_500k", "--both-meshes",
                 "--out", str(out)]) == 0
    recs = json.loads(out.read_text())
    assert [(r["mesh"], r["ok"]) for r in recs] == [("16x16", True), ("2x16x16", True)]
    assert main(["--arch", "no-such-arch", "--shape", "long_500k", "--out", str(out)]) == 1
    (rec,) = json.loads(out.read_text())
    assert not rec["ok"] and rec["error"].startswith("KeyError")


def test_kernel_wrappers_give_shapes_on_meta_tensors():
    """The dry-run runs steps on meta tensors: each wrapper runs its plain
    version there (shapes only), as on the CPU."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.dense_topk import dense_topk
    from repro_torch.kernels.prefill_attention import prefill_attention
    m = functools.partial(torch.empty, device="meta")
    out = decode_attention(m((2, 8, 64)), m((2, 16, 4, 64)), m((2, 16, 4, 64)),
                           m((2,), dtype=torch.int32))
    assert (out.device.type, tuple(out.shape)) == ("meta", (2, 8, 64))
    out = prefill_attention(m((2, 5, 8, 32)), m((2, 5, 4, 32)), m((2, 5, 4, 32)))
    assert (out.device.type, tuple(out.shape)) == ("meta", (2, 5, 8, 32))
    s, i = dense_topk(m((3, 16)), m((100, 16)), 7)
    assert (s.device.type, tuple(s.shape), tuple(i.shape)) == ("meta", (3, 7), (3, 7))
