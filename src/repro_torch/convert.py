"""Carry state across from the JAX package, as plain numpy data.

The port never imports jax; a caller that holds JAX arrays turns them
into numpy first (``np.asarray``) and hands them over here, so both
packages can start from identical parameters and identical key words.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tree import tree_flatten, tree_map

__all__ = ["params_from_numpy", "key_from_words", "check_tree_like"]


def params_from_numpy(tree, device="cpu"):
    """A tree (dict / list / tuple) of numpy arrays -> the same tree of
    tensors on ``device``, values and dtypes unchanged."""
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True))
                    .to(device), tree)


def key_from_words(words) -> np.ndarray:
    """Raw threefry key words — ``np.asarray(jax.random.key_data(k))`` or a
    raw ``jax.random.PRNGKey`` — as the port's key: uint32 (..., 2)."""
    key = np.asarray(words)
    if key.dtype != np.uint32 or key.shape[-1:] != (2,):
        raise ValueError(f"expected uint32 (..., 2) threefry key words, got "
                         f"{key.dtype} {key.shape}")
    return key.copy()


def _paths(tree, prefix=""):
    """{"a/b/c": leaf} in tree order."""
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out.update(_paths(tree[key], f"{prefix}/{key}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, sub in enumerate(tree):
            out.update(_paths(sub, f"{prefix}/{i}"))
        return out
    return {prefix or "/": tree}


def check_tree_like(tree, like) -> None:
    """Raise ValueError unless ``tree`` (e.g. a JAX parameter tree carried
    across by :func:`params_from_numpy`) has the structure of ``like``
    (e.g. the port's ``init_params``, possibly on the ``meta`` device)
    and the same shape and dtype at every leaf."""
    if tree_flatten(tree)[1] != tree_flatten(like)[1]:
        got, want = _paths(tree), _paths(like)
        raise ValueError(f"tree structure differs: only in the tree "
                         f"{sorted(set(got) - set(want))}, only in the "
                         f"model {sorted(set(want) - set(got))}")
    for path, (a, b) in zip(_paths(like), zip(tree_flatten(tree)[0],
                                              tree_flatten(like)[0])):
        if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
            raise ValueError(f"{path}: {a.dtype} {tuple(a.shape)}, expected "
                             f"{b.dtype} {tuple(b.shape)}")
