"""Trees of tensors: flatten, unflatten and map, in `jax.tree_util`'s order.

The port's solver state is plain Python structure over tensors: frozen
dataclasses (`Trajectory`, `BatchedTrajectory`, `ConState`, `MPCState`,
`SolverStats`, `BatchedStats`, `ProblemParams`), tuples, lists and dicts.
These helpers walk it the way `jax.tree_util` walks the JAX package's
pytrees: dataclass fields in declaration order, dict keys sorted, tuples
and lists in order, and `None` an empty node with no leaf.  Anything else
(a tensor, an array, a Python number) is a leaf.  So the leaves of a port
structure line up one for one with those of its JAX counterpart, which is
what lets a checkpoint cross between the packages (`utils/checkpoint.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

_LEAF = "*"


def _node(tree):
    """(kind, aux, children) of an inner node, or None for a leaf."""
    if tree is None:
        return "none", None, []
    if isinstance(tree, dict):
        keys = sorted(tree)
        return "dict", tuple(keys), [tree[k] for k in keys]
    if isinstance(tree, (tuple, list)):
        return type(tree), None, list(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = tuple(f.name for f in dataclasses.fields(tree))
        return type(tree), names, [getattr(tree, n) for n in names]
    return None


def tree_flatten(tree) -> tuple[list, Any]:
    """(leaves, treedef): the leaves in `jax.tree_util.tree_flatten`'s order
    and a description of the structure for `tree_unflatten`."""
    leaves: list = []

    def walk(t):
        node = _node(t)
        if node is None:
            leaves.append(t)
            return _LEAF
        kind, aux, children = node
        return kind, aux, tuple(walk(c) for c in children)

    return leaves, walk(tree)


def tree_unflatten(treedef, leaves):
    """The structure `treedef` (from `tree_flatten`) with `leaves` in it."""
    it = iter(leaves)

    def build(d):
        if d == _LEAF:
            return next(it)
        kind, aux, children = d
        values = [build(c) for c in children]
        if kind == "none":
            return None
        if kind == "dict":
            return dict(zip(aux, values))
        if kind in (tuple, list):
            return kind(values)
        return kind(**dict(zip(aux, values)))

    return build(treedef)


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    """`fn` over the leaves of `tree` (and of the trees in `rest`, which
    must have its structure), rebuilt in that structure."""
    leaves, treedef = tree_flatten(tree)
    others = []
    for other in rest:
        o_leaves, o_def = tree_flatten(other)
        if o_def != treedef:
            raise ValueError("tree_map: the trees differ in structure")
        others.append(o_leaves)
    return tree_unflatten(treedef, [fn(*args) for args in zip(leaves, *others)])
