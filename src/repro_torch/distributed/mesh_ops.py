"""Everything the model code does differently on a mesh, in one place.

A step run as DTensors (``launch.dryrun``, and chip_smoke's step on the
1 x 1 CUDA mesh) goes through the same model code as serving and training
on plain tensors. Each function here is the identity, or the plain op, on a
plain tensor, and on a DTensor does what the reference's partitioner does
for its plain jnp:

* :func:`shard`, :func:`mesh_active`: the reference's activation
  constraint and its ``_mesh_active`` (``repro.models.layers``);
* :func:`gather_fsdp`: a layer's FSDP weights made whole over the mesh
  dims that split the batch, as the partitioner gathers them for the
  products;
* :func:`split_dim`, :func:`merge_dims`: views of a split dim as (heads,
  head dim) and back, gathering first where a shard would cut a head
  (DTensor cannot view such a dim; XLA tiles both new dims);
* :func:`splits_groups`, :func:`kv_for_mesh`: GQA where the query heads
  are split finer than the KV heads;
* :func:`softmax_last`: the softmax written out over a split last dim, so
  that DTensor builds the distributed softmax;
* :func:`elementwise`: an elementwise op DTensor has no strategy for, run
  on each rank's shard;
* :func:`on_mesh`: the attention kernel wrappers' route for DTensor inputs.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed.sharding import Spec, _sanitize, mesh_sizes, to_placements
from repro_torch.tree import tree_map

BATCH = ("pod", "data")             # the batch dim's axes in an activation spec
BLOCK = Spec(BATCH, None, None)     # a block's input and output: (B, S, d) split by batch


def is_distributed(*tensors) -> bool:
    """True when any input is a DTensor (a step run on a mesh)."""
    return any(isinstance(t, DTensor) for t in tensors)


def mesh_active(t: torch.Tensor) -> bool:
    """The reference's ``_mesh_active``: ``t`` is a DTensor on a mesh with
    an axis of more than one device."""
    return isinstance(t, DTensor) and any(s > 1 for s in t.device_mesh.shape)


def shard(x: torch.Tensor, spec) -> torch.Tensor:
    """The reference's sharding constraint: ``x`` redistributed to ``spec``
    (a ``sharding.Spec``) on its own mesh when it is a DTensor, else ``x``
    as it is. As in the reference, axes the mesh lacks are dropped, and so
    is any entry whose axes do not divide their dim (``sharding._sanitize``):
    one set of constraints serves the 1 x 1 mesh, 16 x 16 and 2 x 16 x 16."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    placements = to_placements(_sanitize(spec, x.shape, mesh_sizes(mesh)), mesh)
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(mesh, placements)


def gather_fsdp(tree, x: torch.Tensor):
    """A layer's parameters with their FSDP split undone where the
    activations ``x`` are split by batch: each DTensor leaf made whole over
    the mesh dims that split x's batch dim, its other splits kept, as the
    reference's partitioner gathers an FSDP weight (input dim over 'data')
    for the products of batch-split activations, one layer at a time (its
    gradient is reduce-scattered back). Where x is whole over 'data' (a
    batch of one) the weights stay split and the products leave partial
    sums instead. Plain tensors are returned as they are."""
    if not isinstance(x, DTensor):
        return tree
    batch = [p == Shard(0) for p in x.placements]

    def whole(t):
        if not isinstance(t, DTensor):
            return t
        placements = [Replicate() if b else p for b, p in zip(batch, t.placements)]
        if placements == list(t.placements):
            return t
        return t.redistribute(t.device_mesh, placements)
    return tree_map(whole, tree)


def elementwise(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for an elementwise ``fn``. On a mesh it runs on each rank's
    shard (``local_map`` with x's own placements, a pending partial sum
    reduced first): DTensor registers no sharding for the backward of some
    elementwise ops (``F.logsigmoid``'s)."""
    if not isinstance(x, DTensor):
        return fn(x)
    if any(p.is_partial() for p in x.placements):
        x = x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                           for p in x.placements])
    placements = tuple(x.placements)
    return local_map(fn, out_placements=list(placements), in_placements=(placements,),
                     device_mesh=x.device_mesh)(x)


def _whole_where_cut(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``t`` gathered over the mesh dims that split dim ``dim`` into more
    shards than its first n parts can follow (a shard would cut a part)."""
    if not isinstance(t, DTensor):
        return t
    cut = [i for i, p in enumerate(t.placements) if p == Shard(dim)]
    if n % math.prod(t.device_mesh.shape[i] for i in cut) == 0:
        return t
    return t.redistribute(t.device_mesh, [Replicate() if i in cut else p
                                          for i, p in enumerate(t.placements)])


def split_dim(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``t`` with dim ``dim`` viewed as (n, size / n), as ``reshape`` does.
    On a mesh, a dim split over mesh dims into more shards than n can
    follow is first gathered over those mesh dims: DTensor cannot view it,
    where the reference's partitioner tiles both new dims."""
    t = _whole_where_cut(t, dim, n)
    return t.reshape(t.shape[:dim] + (n, t.shape[dim] // n) + t.shape[dim + 1:])


class _MergeDims(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, start: int, end: int):
        ctx.shape, ctx.start = t.shape, start
        return t.reshape(t.shape[:start] + (-1,) + t.shape[end + 1:])

    @staticmethod
    def backward(ctx, grad):
        grad = _whole_where_cut(grad, ctx.start, ctx.shape[ctx.start])
        return grad.reshape(ctx.shape), None, None


def merge_dims(t: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """``t`` with dims ``start`` .. ``end`` merged into one, as ``reshape``
    does. On a mesh the gradient, which may come back split finer than the
    first merged dim can follow, is gathered as :func:`split_dim` gathers
    before its view."""
    if not isinstance(t, DTensor):
        return t.reshape(t.shape[:start] + (-1,) + t.shape[end + 1:])
    return _MergeDims.apply(t, start, end)


def softmax_last(s: torch.Tensor) -> torch.Tensor:
    """Softmax over the last dim. On a DTensor whose last dim is split over
    the mesh (a window-split cache) it is written out (max, exp, sum), as
    the reference's jnp softmax is, so that DTensor builds the partitioner's
    distributed softmax: an all-reduce of the max and a partial sum, where
    ``torch.softmax`` would gather the whole dim first. Anywhere else it is
    ``torch.softmax``."""
    if isinstance(s, DTensor) and Shard(s.ndim - 1) in s.placements:
        p = torch.exp(s - s.amax(-1, keepdim=True))
        return p / p.sum(-1, keepdim=True)
    return torch.softmax(s, dim=-1)


def splits_groups(q: torch.Tensor, kv_heads: int, dim: int) -> bool:
    """True when ``q`` is a DTensor whose head dim ``dim`` is split over the
    mesh into more shards than ``kv_heads`` can follow, so that a shard
    holds part of a group of query heads: DTensor cannot view such heads as
    (KV, G), where the reference's partitioner tiles both dims."""
    if not isinstance(q, DTensor):
        return False
    n = 1
    for size, p in zip(q.device_mesh.shape, q.placements):
        n *= size if p == Shard(dim) else 1
    return kv_heads % n != 0


def whole_heads(q: torch.Tensor, kv_heads: int, dim: int) -> torch.Tensor:
    """``q`` gathered over its head dim ``dim`` where :func:`splits_groups`
    says a shard would hold part of a group (one query row's heads)."""
    if not splits_groups(q, kv_heads, dim):
        return q
    return q.redistribute(q.device_mesh, [Replicate() if p == Shard(dim) else p
                                          for p in q.placements])


def kv_for_mesh(q, k, v):
    """k, v (B, T, KV, hd) as they are, or, where q (B, S, H, hd) is a
    DTensor whose heads are split finer than the KV heads
    (:func:`splits_groups`), repeated to the H query heads, so that each
    shard of query heads finds its keys locally: the reference's
    partitioner gets the same by tiling the (KV, G) dims. The repeated
    heads are then split as q's are, so the backward's gradient reaches the
    repeat whole."""
    B, T, KV, hd = k.shape
    H = q.shape[2]
    if not splits_groups(q, KV, 2):
        return k, v
    out = []
    for t in (k, v):
        t = t[:, :, :, None].expand(B, T, KV, H // KV, hd).reshape(B, T, H, hd)
        out.append(t.redistribute(t.device_mesh, [
            Shard(2) if qp == Shard(2) else p for qp, p in zip(q.placements, t.placements)]))
    return tuple(out)


def on_mesh(what: str, kernel, plain, args: tuple, rules, *, head_dims=None):
    """An attention wrapper's route for DTensor inputs. Local shards on the
    CPU or the meta device (the dry-run): ``plain(*args)`` op by op on the
    DTensors, so DTensor's propagation partitions the plain version as the
    reference's partitioner does its plain jnp. Local shards on CUDA:
    ``kernel`` on each rank's shards through ``local_map``, with the
    placements the inputs have (never asserted ones), provided each rank
    can attend its shards alone: on every mesh dim of more than one device
    the inputs' placements (a plain tensor counts as Replicate) must be one
    of ``rules``, ``((placement of each arg), output placement)``, and
    where ``head_dims`` gives (q's head dim, k's head dim), each rank's
    shards must hold whole groups: its query heads G times its KV heads,
    G the whole tensors' ratio, and no shard empty (DTensor splits a dim
    unevenly where the mesh does not divide it). Anything else raises:
    there is no drop to the plain version on the card."""
    from repro_torch.kernels._build import on_cpu
    if on_cpu(what, *(t.to_local() if isinstance(t, DTensor) else t for t in args)):
        return plain(*args)
    mesh = next(t.device_mesh for t in args if isinstance(t, DTensor))
    have = tuple(t.placements if isinstance(t, DTensor) else None for t in args)
    out = []
    for i, n in enumerate(mesh.shape):
        got = tuple(Replicate() if p is None else p[i] for p in have)
        want = Replicate() if n == 1 else next((o for r, o in rules if r == got), None)
        if want is None:
            raise ValueError(f"{what}: no kernel route for placements {got} on mesh "
                             f"dim {i} ({n} devices): each rank's shards must be "
                             f"attended alone")
        out.append(want)
    if head_dims is not None:
        qd, kd = head_dims
        group = args[0].shape[qd] // args[1].shape[kd]

        def local(*shards):
            q, k = shards[0], shards[1]
            if min(t.numel() for t in shards if isinstance(t, torch.Tensor)) == 0 \
                    or q.shape[qd] != group * k.shape[kd]:
                raise ValueError(f"{what}: a rank's shards hold {q.shape[qd]} query and "
                                 f"{k.shape[kd]} KV heads ({group} query heads a KV "
                                 f"head wanted, none empty)")
            return kernel(*shards)
    else:
        local = kernel
    return local_map(local, out_placements=out, in_placements=have,
                     device_mesh=mesh)(*args)
