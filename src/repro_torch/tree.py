"""Trees of dicts, lists and tuples (NamedTuples included) with tensors or
other values at the leaves: the helpers the port walks its parameter,
optimizer, decode-state and spec trees with.

Leaves come in ``jax.tree``'s order, dict entries by sorted key, so two
trees with the same keys line up whatever order their dicts were built in
(a restored checkpoint's and a fresh init's). The maps keep the first
tree's structure and match the other trees' dicts by key. ``is_leaf`` marks
a node that is a leaf though it is a tuple (a sharding ``Spec``).
"""
from __future__ import annotations

from typing import Callable, Optional


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _rebuild(like, children):
    """A list or tuple of ``like``'s type holding ``children``."""
    children = list(children)
    return type(like)(*children) if _is_namedtuple(like) else type(like)(children)


def tree_leaves(tree, is_leaf: Optional[Callable] = None) -> list:
    """The leaves of ``tree``, dict entries by sorted key."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v, is_leaf)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` (in ``tree_leaves`` order)."""
    return _unflatten(like, iter(leaves))


def _unflatten(t, it):
    # a module-level function, not a closure that calls itself: such a closure
    # is a reference cycle that would hold ``leaves`` (a decode step's state on
    # the card) until the cyclic collector runs
    if isinstance(t, dict):
        return {k: _unflatten(t[k], it) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return _rebuild(t, (_unflatten(v, it) for v in t))
    return next(it)


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *matching leaves of rest)`` at every leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(t[k] for t in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, (tree_map(fn, *xs) for xs in zip(tree, *rest)))
    return fn(tree, *rest)


def map_with_path(fn: Callable, tree, *, is_leaf: Optional[Callable] = None,
                  path: tuple = ()):
    """``fn(path, leaf)`` at every leaf, ``path`` the tuple of dict keys,
    NamedTuple field names and list indices (as strings) down to it; the
    tree's structure is kept."""
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, is_leaf=is_leaf, path=path + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_path(fn, v, is_leaf=is_leaf, path=path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, is_leaf=is_leaf, path=path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)
