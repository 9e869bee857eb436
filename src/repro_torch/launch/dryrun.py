"""Dry-run: plan every (architecture x input shape) pair on the 16 x 16
single-pod mesh and the 2 x 16 x 16 multi-pod mesh, allocating nothing (the
reference's ``repro.launch.dryrun``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape long_500k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--out FILE]
        [--pricing graph | greedy]

The reference lowers and compiles each pair on a host platform that fakes
512 devices and reads XLA's memory and cost analyses and the collectives of
the partitioned HLO. The port runs each pair's step once, as DTensors on a
``DeviceMesh`` over a fake process group (``launch.mesh``): every argument
is distributed by its spec (``sharding.to_placements``) over meta local
tensors, so nothing is computed or allocated, DTensor's propagation
partitions every op, and the activations are redistributed where the
reference constrains them (``distributed.mesh_ops.shard``). A dispatch mode
(:class:`StepCensus`) watches the run and gives the record
  * ``memory.argument_bytes``: one device's bytes of the step's arguments
    (params, AdamW state, decode state, batch), the local shards' sum;
  * ``flops``: the whole step's floating-point operations, counted on the
    DTensor ops, whose shapes are global (``flops_scope``): the same count
    as ``torch.utils.flop_counter.FlopCounterMode`` over the step on plain
    meta tensors (:func:`step_flops`), where XLA's ``cost_analysis``
    counts one device's share. Only matrix products count; attention runs
    its plain version and counts its whole score matrix, masked entries
    included; a train pair adds the backward and remat's recompute of the
    forward. For llama3.2-1b the prefill and decode counts equal the
    analytic count (tests/test_torch_distributed.py);
  * ``flops_per_device``: the same count over the local ops each DTensor op
    runs on rank 0's shards, XLA's per-device scope;
  * ``collectives``: :func:`collective_census`, the reference's dict, of
    the plan DTensor chose with the record's ``pricing`` (its own graph
    search, or, where asked for, greedy plans: :func:`_cpu_mesh`);
  * ``memory.output_bytes``: rank 0's bytes of the step's outputs, each
    storage once, less any that is an argument's (a pass-through allocates
    nothing);
  * ``memory.temp_bytes``: the peak of the local bytes the step allocated
    and still held, less the outputs' (``temp_scope``): eager execution,
    a tensor freed when Python drops its last reference, no fusion and no
    buffer reuse, where XLA's figure is its fused, scheduled program's.
The reference's ``bytes_accessed`` is not recorded: an unfused eager count
of bytes touched would not be XLA's fused one, and the roofline does not
read it. The run is on the CPU and touches no card. A pair that fails is a
record with ``ok: false`` and its error; the exit code is 1 unless every
pair is ok.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
import weakref
from unittest import mock

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ASSIGNED_ARCHS, SHAPES
from repro_torch.distributed.sharding import is_spec, to_placements
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import make_step
from repro_torch.tree import tree_leaves, tree_unflatten

FLOPS_SCOPE = ("global: the whole step on every device together (the DTensor ops' global "
               "shapes), where XLA's cost_analysis counts one device's share "
               "(flops_per_device); matrix products only, attention over its whole score "
               "matrix (masked entries included), a train step with its backward and "
               "remat's recompute")
TEMP_SCOPE = ("one device's peak of live bytes the step allocated, less its outputs, under "
              "eager execution: no fusion, no buffer reuse beyond Python's refcounts, "
              "attention through its plain version (its whole score matrix)")

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# the functional collectives DTensor issues -> the reference's HLO kinds
_KIND = {"all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all"}
_FUNCTIONAL = ("_c10d_functional", "c10d_functional", "_c10d_functional_autograd",
               "_dtensor")


def collective_census(records) -> dict:
    """The reference's census from ``records``, one ``(kind, output bytes
    on one device)`` per collective the step issued: ``{kind: {"count",
    "bytes"}}`` for the reference's five kinds, and ``total_bytes``. The
    kinds are DTensor's functional collectives (``_c10d_functional``,
    ``c10d_functional`` and their autograd forms, in-place forms included):
    ``all_gather_into_tensor[_coalesced]`` -> all-gather,
    ``all_reduce[_coalesced]`` -> all-reduce,
    ``reduce_scatter_tensor[_coalesced]`` -> reduce-scatter,
    ``all_to_all_single`` and DTensor's ``_dtensor.shard_dim_alltoall`` ->
    all-to-all; none maps to collective-permute (DTensor moves shards
    between ranks with all-to-all). Bytes are the
    output's, as the reference sums the output shapes of the HLO op."""
    census = {c: {"count": 0, "bytes": 0} for c in COLLECTIVES}
    for kind, nbytes in records:
        census[kind]["count"] += 1
        census[kind]["bytes"] += nbytes
    census["total_bytes"] = sum(census[c]["bytes"] for c in COLLECTIVES)
    return census


def _flops(func, args, kwargs, out) -> int:
    from torch.utils.flop_counter import flop_registry
    formula = flop_registry.get(func._overloadpacket)
    return 0 if formula is None else int(formula(*args, **kwargs, out_val=out))


def _local_tensors(tree) -> list:
    from torch.distributed.tensor import DTensor
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _storage(t: torch.Tensor):
    s = t.untyped_storage()
    return s._cdata, s.nbytes()


class StepCensus(TorchDispatchMode):
    """A dispatch mode over one run of a step on DTensors. An op on
    DTensors is counted for the global FLOPs and handed back
    (``NotImplemented``) to DTensor, which runs it on the local shards
    under this mode again: those local ops give the per-device FLOPs, the
    collectives (:func:`collective_census`) and the live bytes. The ops
    DTensor runs on fake tensors to propagate shapes are not the step's and
    count nothing. ``args`` are the step's arguments, whose storages are
    not the step's allocations."""

    def __init__(self, args=()):
        super().__init__()
        self.flops = self.flops_per_device = 0
        self.records = []
        self.args = {_storage(t)[0] for t in _local_tensors(args)}
        self.live = self.peak = 0
        self._holders = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            return func(*args, **kwargs)        # DTensor's shape propagation
        flat = tree_leaves((args, kwargs))
        if any(isinstance(t, DTensor) for t in flat):
            self.flops += _flops(func, args, kwargs, None)
            return NotImplemented
        out = func(*args, **kwargs)
        self.flops_per_device += _flops(func, args, kwargs, out)
        if func.namespace in _FUNCTIONAL:
            name = func._overloadpacket.__name__.rstrip("_")
            if name in _KIND:
                self.records.append((_KIND[name], sum(
                    t.numel() * t.element_size() for t in _local_tensors(out))))
            elif name not in ("wait_tensor", "_wrap_tensor_autograd"):
                raise NotImplementedError(f"collective {func} has no census kind")
        for t in _local_tensors(out):
            self._hold(t)
        return out

    def _hold(self, t: torch.Tensor) -> None:
        key, nbytes = _storage(t)
        if key in self.args:
            return
        if key not in self._holders:
            self._holders[key] = 0
            self.live += nbytes
            self.peak = max(self.peak, self.live)
        self._holders[key] += 1
        weakref.finalize(t, self._drop, key, nbytes)

    def _drop(self, key, nbytes: int) -> None:
        self._holders[key] -= 1
        if not self._holders[key]:
            del self._holders[key]
            self.live -= nbytes

    def output_bytes(self, out) -> int:
        """Rank 0's bytes of ``out``'s tensors, each storage once, less the
        arguments'."""
        seen = dict(_storage(t) for t in _local_tensors(out))
        return sum(n for key, n in seen.items() if key not in self.args)


def distribute(args, specs, mesh):
    """``args`` with each tensor leaf a DTensor over ``mesh`` placed by its
    spec (host values as they are)."""
    from torch.distributed.tensor import distribute_tensor
    leaves = [distribute_tensor(leaf, mesh, to_placements(spec, mesh))
              if isinstance(leaf, torch.Tensor) else leaf
              for leaf, spec in zip(tree_leaves(args), tree_leaves(specs, is_spec))]
    return tree_unflatten(args, leaves)


def _all_to_all(local, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's move of a shard from one tensor dim to another as the
    all-to-all it issues on an accelerator mesh: on a CPU mesh it gathers
    the whole dim and chunks it instead (Gloo has no all-to-all), which the
    census would count as an all-gather of the whole dim."""
    import torch.distributed._functional_collectives as funcol
    group = funcol._resolve_group((mesh, mesh_dim))
    return torch.ops._dtensor.shard_dim_alltoall(local, gather_dim, shard_dim,
                                                 funcol._group_or_group_name(group))


PRICINGS = ("graph", "greedy")


_decided_by = [None]     # the pricing of the strategies DTensor has cached


@contextlib.contextmanager
def _cpu_mesh(mesh, pricing: str = "graph"):
    """DTensor on a CPU mesh made to plan as on an accelerator mesh:
      * a shard moves between tensor dims by all-to-all
        (:func:`_all_to_all`), into a contiguous shard (DTensor's
        unpadding of an uneven dim leaves a strided view that a later view
        of the DTensor cannot take);
      * with ``pricing="greedy"``, DTensor prices the candidate strategies
        of an op with greedy redistribution plans (one mesh dim at a time)
        where it would search a graph for placements that hold a strided
        shard (a dim split over two mesh dims and then merged, as
        attention's batched products merge batch and heads). Greedy plans
        of such placements can cost a strategy wrongly, so the op may take
        another strategy than DTensor's planner would (collective bytes a
        device, greedy- against graph-priced: qwen2-moe-a2.7b x decode_32k
        on 16 x 16, 105 GB against 1.98 GB; paligemma-3b x long_500k on
        2 x 16 x 16, 175,873,448 against 14,222,504). The redistributions
        it then runs keep the graph search, which their correctness needs.
    Plans are cached process-wide, so that cache is cleared on the way in
    and out. DTensor's sharding decisions (its propagation caches, Python
    and native) are too, and are cleared when the pricing differs from the
    last run's: a run's strategies are its own pricing's, never ones an
    earlier run priced otherwise chose. Nothing is patched on any other
    mesh."""
    if pricing not in PRICINGS:
        raise ValueError(f"pricing {pricing!r} is not one of {PRICINGS}")
    if mesh.device_type != "cpu":
        yield
        return
    import functools
    from torch.distributed.tensor import _collective_utils, _redistribute
    import torch.distributed.tensor._ops.utils as op_utils
    import torch.distributed.tensor.placement_types as placement_types
    from torch.distributed.tensor.debug import _clear_sharding_prop_cache
    move = placement_types.Shard._to_new_shard_dim
    planned = _redistribute._gen_transform_infos
    pricing_now = []

    @functools.cache
    def greedy_plan(src, dst, use_graph_based_transform=None):
        planner = _redistribute.get_redistribute_planner(src.device_mesh, src.tensor_meta)
        return planner.generate_greedy_transform_infos(src, dst)

    def plan(src, dst, use_graph_based_transform=None):
        return (greedy_plan if pricing_now else planned)(src, dst, use_graph_based_transform)

    def price(src, dst):
        pricing_now.append(True)
        try:
            return _collective_utils.redistribute_cost(src, dst)
        finally:
            pricing_now.pop()

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(placement_types, "shard_dim_alltoall",
                                              _all_to_all))
        stack.enter_context(mock.patch.object(
            placement_types.Shard, "_to_new_shard_dim",
            lambda self, *a, **k: move(self, *a, **k).contiguous()))
        if pricing == "greedy":
            stack.enter_context(mock.patch.object(_redistribute, "_gen_transform_infos", plan))
            stack.enter_context(mock.patch.object(op_utils, "redistribute_cost", price))
        stack.callback(planned.cache_clear)
        planned.cache_clear()
        if _decided_by[0] != pricing:
            _clear_sharding_prop_cache()
            _decided_by[0] = pricing
        yield


def run_distributed(fn, args, specs, mesh, *, pricing: str = "graph"):
    """``fn`` run once on ``args`` distributed over ``mesh`` -> (its output,
    the :class:`StepCensus` of the run). Plain tensors the step makes
    (positions, masks) count as replicated (``implicit_replication``); on
    a CPU mesh DTensor plans as :func:`_cpu_mesh` says, with ``pricing``."""
    from torch.distributed.tensor.experimental import implicit_replication
    dargs = distribute(args, specs, mesh)
    census = StepCensus(dargs)
    with _cpu_mesh(mesh, pricing), implicit_replication(), census:
        out = fn(*dargs)
    return out, census


def argument_bytes(args, specs, mesh) -> int:
    """One device's bytes of ``args``: each tensor leaf distributed over
    ``mesh`` by its spec, its local shard's numel times its element size
    (meta tensors: nothing is allocated). Host values count nothing."""
    return sum(t.numel() * t.element_size()
               for t in _local_tensors(distribute(args, specs, mesh)))


def step_flops(fn, args) -> int:
    """The operations of ``fn(*args)`` run on the meta arguments as they are
    (shapes only; the kernel wrappers run their plain versions on meta
    tensors)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.mesh.shape)


def dryrun_pair(arch: str, shape: str, *, multi_pod: bool = False, mesh=None,
                pricing: str = "graph", verbose: bool = True, **overrides) -> dict:
    """One pair's record (module docstring): ``arch``, ``shape``, ``mesh``,
    ``pricing``, ``ok``, ``error``, and when ok ``flops`` (with
    ``flops_scope``), ``flops_per_device``, ``collectives``, ``memory``
    (``argument_bytes``, ``output_bytes``, ``temp_bytes``, with
    ``temp_scope``) and the seconds taken. ``mesh`` (default: the
    production mesh ``multi_pod`` names) and ``overrides`` (``make_step``'s
    keywords) pick the plan; ``pricing`` how DTensor prices its candidate
    strategies (:func:`_cpu_mesh`): its graph search takes 4-27x as long as
    greedy pricing on 2 x 16 x 16's train and prefill steps (up to ~45
    minutes a pair on one core, over an hour for paligemma-3b's train
    step); where both ran, greedy pricing chose costlier plans for
    jamba-v0.1-52b's steps and qwen2-moe-a2.7b's decode, and the same plans
    elsewhere."""
    mesh = make_production_mesh(multi_pod=multi_pod) if mesh is None else mesh
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name(mesh), "pricing": pricing,
           "ok": False, "error": None}
    t0 = time.perf_counter()
    try:
        fn, args, specs = make_step(arch, shape, mesh, **overrides)
        nbytes = argument_bytes(args, specs, mesh)
        t_plan = time.perf_counter() - t0
        out, census = run_distributed(fn, args, specs, mesh, pricing=pricing)
        out_bytes = census.output_bytes(out)
        coll = collective_census(census.records)
        rec.update(ok=True, plan_s=round(t_plan, 2),
                   trace_s=round(time.perf_counter() - t0 - t_plan, 2),
                   flops=census.flops, flops_scope=FLOPS_SCOPE,
                   flops_per_device=census.flops_per_device, collectives=coll,
                   memory={"argument_bytes": nbytes, "output_bytes": out_bytes,
                           "temp_bytes": max(census.peak - out_bytes, 0),
                           "temp_scope": TEMP_SCOPE})
        if verbose:
            print(f"[OK] {arch} x {shape} ({rec['mesh']}, {pricing} pricing) plan "
                  f"{t_plan:.1f}s trace {rec['trace_s']:.1f}s flops {census.flops:.3g} (global), "
                  f"{census.flops_per_device:.3g} a device; collectives "
                  f"{coll['total_bytes']:.4g} B a device; memory {rec['memory']}")
    except Exception as e:  # noqa: BLE001 — a dry-run failure is a finding, not a crash
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[FAIL] {arch} x {shape} ({rec['mesh']}): {rec['error']}")
    rec["seconds"] = round(time.perf_counter() - t0, 2)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--pricing", choices=PRICINGS, default="graph",
                    help="how DTensor prices its candidate strategies: graph "
                         "(DTensor's planner) or greedy (faster, and may choose a "
                         "costlier plan)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = [dryrun_pair(a, s, multi_pod=mp, pricing=args.pricing) for mp in meshes
               for a in archs for s in shapes]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    n_ok = sum(r["ok"] for r in results)
    print(f"\n{n_ok}/{len(results)} pairs planned")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
