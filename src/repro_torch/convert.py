"""Carry state across from the JAX package, as plain numpy data.

The port never imports jax; a caller that holds JAX arrays turns them
into numpy first (``np.asarray``) and hands them over here, so both
packages can start from identical parameters and identical key words.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tree import tree_map

__all__ = ["params_from_numpy", "key_from_words"]


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
