"""Sharding rules: parameter, decode-state and batch trees -> specs -> DTensor
placements (the reference's ``repro.distributed.sharding``, rule for rule).

Policy, as the reference's:
  * batch dims over ('pod', 'data'); 'model' carries tensor parallelism;
  * 2-D weights: input dim over 'data' (FSDP), output dim over 'model' (TP),
    flipped for output projections so activations stay batch-major;
  * MoE experts over 'model' (expert parallelism) when the expert count
    divides the axis, otherwise TP over the expert FFN dim;
  * anything that does not divide cleanly is replicated (never an error), so
    one rule set serves the 1 x 1 mesh of one process, 16 x 16 and
    2 x 16 x 16.

A :class:`Spec` is plain data, one entry per tensor dim: ``None``, a mesh
axis name, or a tuple of axis names; it equals the tuple of the reference's
``PartitionSpec`` with the same entries. :func:`to_placements` turns one into
DTensor placements over a ``DeviceMesh``.

The port keeps its layers unstacked (``models.model``), while the reference
stacks the layers of a repeated period along a leading axis. The rules read
a leaf's trailing dims only, so a port leaf's spec is the reference's spec of
its stacked counterpart without the leading ``None``
(``models.convert.stacked_leaves`` says which leaves those are). The decode
state is stacked in both packages (``Model.init_decode_state_stacked``) and
gets the reference's specs as they are.

Trees are dicts, lists, tuples and NamedTuples (the optimizer state); a
leaf's path is its dict keys and field names, with list and tuple indices as
digit strings, which the rules skip.
"""
from __future__ import annotations

from torch.distributed.tensor import Replicate, Shard

from repro_torch.tree import map_with_path


class Spec(tuple):
    """A partition spec: ``Spec("data", None, ("pod", "model"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


def mesh_sizes(mesh) -> dict:
    """Axis name -> size of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _fits(dim: int, axes, sizes) -> bool:
    prod = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        if a not in sizes:
            return False
        prod *= sizes[a]
    return dim % prod == 0


def _sanitize(spec, shape, sizes) -> Spec:
    """One entry per dim of ``shape``: each kept where its axes exist and
    their sizes divide the dim, else None."""
    out = []
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, e in enumerate(entries[: len(shape)]):
        if e is None:
            out.append(None)
            continue
        axes = e if isinstance(e, tuple) else (e,)
        kept = tuple(a for a in axes if a in sizes)
        if kept and _fits(shape[i], kept, sizes):
            out.append(kept if len(kept) > 1 else kept[0])
        else:
            out.append(None)
    return Spec(*out)


def batch_axes(mesh) -> tuple:
    """The axes a batch dim is split over: 'pod' and 'data' where ``mesh``
    (a ``DeviceMesh``, or its axis names) has them."""
    names = getattr(mesh, "mesh_dim_names", mesh)
    return tuple(a for a in ("pod", "data") if a in names)


_IN_OUT = Spec("data", "model")     # (d_in, d_out)
_OUT_IN = Spec("model", "data")     # output projections


def _param_rule(path_names, name: str, shape, sizes) -> tuple:
    """-> (base spec, semantic rank). Leading dims beyond the rank are
    stacked layer storage and get None."""
    in_moe = "moe" in path_names and "shared" not in path_names
    if name == "embed":
        return Spec("model", "data"), 2
    if name == "unembed":
        return Spec("data", "model"), 2
    if name in ("wq", "wk", "wv", "up_proj", "in_proj", "w_gates", "w_if"):
        return _IN_OUT, 2
    if name in ("wo", "down_proj", "out_proj"):
        return _OUT_IN, 2
    if name in ("w_gate", "w_up"):
        if in_moe:  # experts (E, d, f): EP over 'model', the expert FFN dim over 'data'
            if _fits(shape[-3], ("model",), sizes):
                return Spec("model", None, "data"), 3
            return Spec(None, "data", "model"), 3
        return _IN_OUT, 2
    if name == "w_down":
        if in_moe:  # (E, f, d)
            if _fits(shape[-3], ("model",), sizes):
                return Spec("model", "data", None), 3
            return Spec(None, "model", "data"), 3
        return _OUT_IN, 2
    if name == "router":
        return Spec("data", None), 2
    if name == "conv_w":
        return Spec(None, "model"), 2
    if name in ("conv_b", "dt_bias", "D", "bq", "bk", "bv"):
        return Spec("model"), 1
    if name in ("A_log", "x_proj"):
        return Spec("model", None), 2
    if name == "dt_proj":
        return Spec(None, "model"), 2
    return Spec(), 0  # norms, gate biases, r_gates, q_norm/k_norm: replicated


def is_spec(x) -> bool:
    """``is_leaf`` for the ``repro_torch.tree`` helpers over a spec tree."""
    return isinstance(x, Spec)


def param_specs(params, mesh, *, fsdp: bool = True, tp: bool = True):
    """Spec tree for a parameter tree (or one that mirrors it, as the AdamW
    moments do). ``fsdp=False`` drops the 'data'-axis weight sharding;
    ``tp=False`` also drops 'model' (pure data parallelism)."""
    sizes = mesh_sizes(mesh)

    def rule(names, leaf):
        name = next((n for n in reversed(names) if n and not n.isdigit()), "")
        shape = tuple(leaf.shape)
        base, rank = _param_rule(names, name, shape, sizes)
        if not fsdp:
            base = Spec(*[None if e == "data" else e for e in base])
        if not tp:
            base = Spec(*[None if e == "model" else e for e in base])
        lead = len(shape) - rank
        spec = Spec(*((None,) * lead + tuple(base))) if lead > 0 else base
        return _sanitize(spec, shape, sizes)

    return map_with_path(rule, params)


def state_specs(state, mesh, batch: int, *, kv_shard: str = "replicated"):
    """Spec tree for a stacked decode state (KV caches, recurrent states).
    ``kv_shard`` places the attention caches on the 'model' axis on top of
    the batch sharding: 'replicated', 'head_dim' (contraction-sharded
    attention) or 'window' (sequence-sharded decode)."""
    sizes = mesh_sizes(mesh)
    ba = batch_axes(mesh)

    def rule(names, leaf):
        name = next((n for n in reversed(names) if not n.isdigit()), None)
        shape = tuple(leaf.shape)
        nd = len(shape)
        if name in ("k", "v", "cross_k", "cross_v"):
            if kv_shard == "head_dim":
                base = (Spec(ba, None, None, "model") if batch > 1
                        else Spec(None, "data", None, "model"))
            elif kv_shard == "window":
                base = (Spec(ba, "model", None, None) if batch > 1
                        else Spec(None, ("data", "model"), None, None))
            else:
                base = (Spec(ba, None, None, None) if batch > 1
                        else Spec(None, "data", None, None))
        elif name == "h" and nd >= 3:       # mamba (B, d_in, N)
            base = Spec(ba, "model", None)
        elif name == "conv":                 # (B, dc-1, d_in)
            base = Spec(ba, None, "model")
        elif name == "C":                    # mlstm (B, H, hd, hd)
            base = Spec(ba, "model", None, None)
        elif name == "n" and nd == 3:
            base = Spec(ba, "model", None)
        elif name in ("c", "n", "h", "m"):   # slstm (B, d_in)
            base = Spec(ba, "model")
        else:
            base = Spec()
        if len(base) < nd and nd == len(base) + 1:   # stacked repeats
            base = Spec(None, *base)
        return _sanitize(base, shape, sizes)

    return map_with_path(rule, state)


def data_specs(batch_dict, mesh, *, batch_over_model: bool = False):
    """Spec tree for a batch: the leading dim over the batch axes (and over
    'model' too with ``batch_over_model``: pure-DP small models)."""
    ba = batch_axes(mesh)
    if batch_over_model:
        ba = ba + ("model",)
    sizes = mesh_sizes(mesh)
    return map_with_path(
        lambda _, leaf: _sanitize(Spec(ba, *([None] * (leaf.ndim - 1))), leaf.shape, sizes),
        batch_dict)


def to_placements(spec, mesh) -> list:
    """A spec -> one DTensor placement per mesh dim: ``Shard(d)`` on each
    mesh dim that tensor dim d names, ``Replicate()`` on the others and on
    every mesh dim of size 1 (a shard over one device is the whole tensor,
    and DTensor would otherwise move it through one-rank collectives).
    DTensor splits a tensor dim over several mesh dims in mesh order, so a
    tuple entry must list its axes in that order (data-major, as the
    reference's ``PartitionSpec`` splits them)."""
    names = list(mesh.mesh_dim_names)
    sizes = mesh_sizes(mesh)
    out = [Replicate() for _ in names]
    for d, e in enumerate(spec):
        if e is None:
            continue
        axes = e if isinstance(e, tuple) else (e,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {e!r} is not in the mesh's axis order {names}")
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return out
