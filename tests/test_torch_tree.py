"""The port's tree helpers (``repro_torch.tree``): the leaves' order, the
rebuild, and that a rebuilt tree holds its leaves by plain references only."""
import gc
import weakref
from collections import namedtuple

import pytest

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Pair = namedtuple("Pair", "a b")


class Leaf:
    pass


def test_unflatten_inverts_leaves_with_dicts_by_sorted_key():
    tree = [{"v": 1, "k": 2}, (3, Pair(4, {"z": 5, "a": 6}))]
    leaves = tree_leaves(tree)
    assert leaves == [2, 1, 3, 4, 6, 5]
    back = tree_unflatten(tree, [x * 10 for x in leaves])
    assert back == [{"k": 20, "v": 10}, (30, Pair(40, {"a": 60, "z": 50}))]
    assert isinstance(back[1][1], Pair)
    assert tree_map(lambda x: x * 10, tree) == back


@pytest.mark.parametrize("like", [[{"k": 0, "v": 0}] * 3, ({"ssm": {"c": 0, "n": 0}},)])
def test_an_unflattened_tree_is_freed_without_the_cyclic_collector(like):
    """A decode step's state is rebuilt each step on the card: a reference
    cycle in the rebuild would keep every step's state until ``gc`` ran."""
    leaves = [Leaf() for _ in tree_leaves(like)]
    refs = [weakref.ref(x) for x in leaves]
    enabled = gc.isenabled()
    gc.disable()
    try:
        tree = tree_unflatten(like, leaves)
        assert tree_leaves(tree) == leaves
        del tree, leaves
        assert all(r() is None for r in refs)
    finally:
        if enabled:
            gc.enable()
