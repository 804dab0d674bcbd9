"""Rollout of Algorithm 1 over a window of steps — the counterpart of
``repro.core.rollout.rollout_l2gd``.

The reference runs the window inside one ``lax.scan``; here it is a
Python loop that never waits on the device: the xi draws and the per-step
compressor keys of the whole window come from one vectorised numpy pass
on the host, the branch of each step is picked in Python from them, and
the per-step losses are written into a preallocated device tensor that
the caller fetches once per window.

Determinism contract (the reference's): ``xi_key, noise_key =
split(key)``; step k draws ``xi_k = bernoulli(fold_in(xi_key, k), p)``
and gives the step ``fold_in(noise_key, k)`` for compressor randomness,
with k the GLOBAL step counter ``state.step``, so chunking is invisible.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.compressors import Identity
from repro_torch.core.l2gd import L2GDHyper, L2GDState, l2gd_step
from repro_torch.core.tree import tree_leaves, tree_map

__all__ = ["RolloutTrace", "rollout_l2gd", "window_streams"]


class RolloutTrace(NamedTuple):
    """Trace of one rollout window."""

    losses: torch.Tensor    # (K,) f32 mean client loss, pre-update params
    xis: np.ndarray         # (K,) int32 xi_k realization
    branches: np.ndarray    # (K,) int32 protocol branch (0/1/2)
    n_local: int            # branch-0 steps
    n_agg_comm: int         # branch-1 steps (fresh communication)
    n_agg_cached: int       # branch-2 steps (cached target)


def window_streams(key, p, start: int, length: int, xi_trace=None):
    """(xis (length,) int32, step keys (length, 2)) for global steps
    ``start .. start+length-1``, both from one vectorised pass."""
    xi_key, noise_key = prng.split(key)
    ks = start + np.arange(length, dtype=np.int64)
    if xi_trace is None:
        xis = prng.bernoulli(prng.fold_in(xi_key, ks), p).astype(np.int32)
    else:
        xis = np.asarray(xi_trace, np.int32).reshape(length)
    return xis, prng.fold_in(noise_key, ks)


def _rollout_length(batches, batch_axis, xi_trace, steps) -> int:
    lengths = {}
    if steps is not None:
        lengths["steps="] = int(steps)
    if xi_trace is not None:
        lengths["xi_trace"] = int(np.asarray(xi_trace).shape[0])
    if batch_axis == 0:
        leaves = tree_leaves(batches)
        if leaves:
            lengths["batches"] = int(leaves[0].shape[0])
    if not lengths:
        raise ValueError(
            "rollout length is undetermined: pass steps=, a stacked "
            "batches tree (batch_axis=0) or an xi_trace")
    if len(set(lengths.values())) != 1:
        raise ValueError(f"inconsistent rollout lengths: {lengths}")
    return next(iter(lengths.values()))


def rollout_l2gd(key, state: L2GDState, hp: L2GDHyper, batches,
                 xi_trace: Optional[Any] = None, *, grad_fn: Callable,
                 steps: Optional[int] = None, client_comp=Identity(),
                 master_comp=Identity(), batch_axis: Optional[int] = 0,
                 local_steps: int = 1, loss_fn: Optional[Callable] = None):
    """Run K steps of Algorithm 1 from ``state``.

    ``batches`` is a tree whose leaves carry a leading (K, ...) steps axis
    (``batch_axis=0``) or one batch reused every step (``batch_axis=None``).
    ``xi_trace`` optionally forces the xi realization; ``loss_fn`` is
    :func:`~repro_torch.core.l2gd.l2gd_step`'s.  Returns
    ``(final_state, RolloutTrace)``; the losses stay on the device."""
    length = _rollout_length(batches, batch_axis, xi_trace, steps)
    xis, subs = window_streams(key, hp.p, state.step, length, xi_trace)
    device = tree_leaves(state.params)[0].device
    losses = torch.empty((length,), dtype=torch.float32, device=device)
    branches = np.empty((length,), np.int32)
    for i in range(length):
        batch = batches if batch_axis is None else \
            tree_map(lambda a: a[i], batches)
        state, metrics = l2gd_step(state, batch, int(xis[i]), subs[i],
                                   grad_fn, hp, client_comp, master_comp,
                                   local_steps=local_steps, loss_fn=loss_fn)
        losses[i] = metrics["loss"]
        branches[i] = metrics["branch"]
    return state, RolloutTrace(
        losses=losses, xis=xis, branches=branches,
        n_local=int(np.sum(branches == 0)),
        n_agg_comm=int(np.sum(branches == 1)),
        n_agg_cached=int(np.sum(branches == 2)))
