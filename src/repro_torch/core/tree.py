"""Parameter trees: nested ``dict`` / ``list`` / ``tuple`` containers of
tensors, the port's stand-in for JAX pytrees.

Leaves are visited in ``jax.tree_util`` order — dict keys sorted, lists,
tuples and NamedTuples (a decode cache) in position order — so a tree
raveled here has the same leaf offsets as the same tree raveled by the
JAX package.
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_flatten", "tree_unflatten", "tree_leaves", "tree_map",
           "spec_leaves"]


def tree_flatten(tree) -> tuple:
    """(leaves, treedef); anything that is not a dict, list or tuple is a
    leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
        return ([leaf for ls, _ in parts for leaf in ls],
                ("dict", tuple(keys), tuple(d for _, d in parts)))
    if isinstance(tree, (list, tuple)):
        parts = [tree_flatten(x) for x in tree]
        # a NamedTuple keeps its class, to be rebuilt as one
        kind = type(tree) if hasattr(tree, "_fields") \
            else type(tree).__name__
        return ([leaf for ls, _ in parts for leaf in ls],
                (kind, None, tuple(d for _, d in parts)))
    return [tree], None


def _count(treedef) -> int:
    if treedef is None:
        return 1
    return sum(_count(d) for d in treedef[2])


def _build(treedef, it):
    if treedef is None:
        return next(it)
    kind, keys, children = treedef
    kids = [_build(c, it) for c in children]
    if kind == "dict":
        return dict(zip(keys, kids))
    if kind == "tuple":
        return tuple(kids)
    return kind(*kids) if isinstance(kind, type) else kids


def tree_unflatten(treedef, leaves) -> Any:
    # module-level recursion: a recursive closure would form a reference
    # cycle holding the leaves (model-sized tensors) until the cyclic GC
    leaves = list(leaves)
    if len(leaves) != _count(treedef):
        raise ValueError(f"{len(leaves)} leaves for a tree of "
                         f"{_count(treedef)}")
    return _build(treedef, iter(leaves))


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """Apply ``fn`` leafwise over trees of the same structure."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(t) for t in rest]
    for _, d in others:
        if d != treedef:
            raise ValueError("tree_map over trees of different structure")
    return tree_unflatten(treedef, [fn(*xs) for xs in
                                    zip(leaves, *(ls for ls, _ in others))])


def spec_leaves(spec_tree) -> list:
    """The leaves of a partition-spec tree in :func:`tree_leaves` order: a
    plain tuple (one entry a dim) is a leaf, dicts, lists and NamedTuples
    are containers."""
    if isinstance(spec_tree, dict):
        return [s for k in sorted(spec_tree)
                for s in spec_leaves(spec_tree[k])]
    if isinstance(spec_tree, list) or hasattr(spec_tree, "_fields"):
        return [s for x in spec_tree for s in spec_leaves(x)]
    return [spec_tree]
