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

Partial participation (DESIGN.md §9): ``participation=f`` samples a
fixed-size subset of s = ``participant_count(n, f)`` clients for every
aggregation step from a THIRD stream, ``part_key = fold_in(xi_key,
2**32 - 1)``, step k's mask from ``fold_in(part_key, k)`` — the s
smallest of n uniforms, drawn on the host with the xi stream.  s == n
runs the full-participation path (no masks).

:func:`rollout_l2gd_grid` runs one rollout per cell of a (p, lambda,
eta) grid (:func:`hyper_grid`), every cell from the same initial state
and key (common random numbers) — the reference vmaps the rollout over
the grid, here the cells run one after another.

:func:`rollout_l2gd_sharded` runs the same step loop SPMD over the
processes of a ``clients`` mesh axis, each on its own clients, the fresh
branch's collective carrying the clients' wire payloads.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.compressors import Identity
from repro_torch.core.l2gd import (L2GDHyper, L2GDState, init_state,
                                   l2gd_step, make_hyper)
from repro_torch.core.tree import tree_leaves, tree_map

__all__ = ["RolloutTrace", "rollout_l2gd", "rollout_l2gd_grid", "hyper_grid",
           "window_streams", "participant_count", "draw_participation_mask",
           "participation_masks", "state_to_tree", "state_from_tree",
           "sharded_state_specs", "rollout_l2gd_sharded"]

#: the participation stream's tag: ``fold_in(xi_key, 2**32 - 1)``, disjoint
#: from the xi stream's nonnegative int32 step folds
PARTICIPATION_STREAM_TAG = np.uint32(2 ** 32 - 1)


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


def participant_count(n: int, participation) -> int:
    """Static participant subset size |S| = round(participation * n),
    clamped to [1, n] — the one place the fraction becomes a count: the
    mask sampler and the ledger's sampled-round rule
    (:meth:`repro_torch.fl.ledger.BitsLedger.replay_xi_trace`) both read
    it, so the bits charged always match the subset drawn."""
    if not (0.0 < float(participation) <= 1.0):
        raise ValueError(
            f"participation must be in (0, 1], got {participation}")
    return max(1, min(int(n), int(round(float(participation) * int(n)))))


def draw_participation_mask(key, n: int, s: int) -> np.ndarray:
    """(..., n) 0/1 float32 mask with EXACTLY ``s`` participants for a key
    (or a batch of keys (..., 2)): the s smallest of n uniforms, ties to
    the lower index (the reference's stable argsort)."""
    keys = np.asarray(key, np.uint32)
    batch = keys.shape[:-1]
    if s >= n:
        return np.ones(batch + (n,), np.float32)
    order = np.argsort(prng.uniform(keys, (n,)), axis=-1, kind="stable")
    mask = np.zeros(batch + (n,), np.float32)
    np.put_along_axis(mask, order[..., :s], np.float32(1.0), axis=-1)
    return mask


def participation_masks(xi_key, ks, n: int, s: int) -> np.ndarray:
    """The (len(ks), n) participant masks of the global steps ``ks`` —
    the third stream: ``part_key = fold_in(xi_key, 2**32 - 1)``, step k's
    mask from ``fold_in(part_key, k)``; chunk-invariant because k is the
    global step counter."""
    part_key = prng.fold_in(xi_key, PARTICIPATION_STREAM_TAG)
    return draw_participation_mask(
        prng.fold_in(part_key, np.asarray(ks, np.int64)), n, s)


def window_masks(key, n: int, participation, start: int,
                 length: int) -> Optional[np.ndarray]:
    """The window's participation masks, or None at full participation
    (``participation=None`` or s == n)."""
    if participation is None:
        return None
    s = participant_count(n, participation)
    if s >= n:
        return None
    xi_key, _ = prng.split(key)
    return participation_masks(xi_key, start + np.arange(length), n, s)


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
                 participation: Optional[float] = None,
                 local_steps: int = 1, loss_fn: Optional[Callable] = None,
                 average_fn: Optional[Callable] = None, axis_name=None):
    """Run K steps of Algorithm 1 from ``state``.

    ``batches`` is a tree whose leaves carry a leading (K, ...) steps axis
    (``batch_axis=0``) or one batch reused every step (``batch_axis=None``).
    ``xi_trace`` optionally forces the xi realization; ``participation``
    (optional fraction in (0, 1]) samples each aggregation step's
    participants (module docstring); ``loss_fn``, ``average_fn`` and
    ``axis_name`` are :func:`~repro_torch.core.l2gd.l2gd_step`'s (the
    sharded engines pass their per-shard average and client axis; the
    xi draws, keys and masks stay those of the hp.n global clients).
    Returns ``(final_state, RolloutTrace)``; the losses stay on the
    device.  The loop drops each state as the next comes: a caller that
    wants the window's first params freed early passes its only
    reference."""
    length = _rollout_length(batches, batch_axis, xi_trace, steps)
    xis, subs = window_streams(key, hp.p, state.step, length, xi_trace)
    masks = window_masks(key, int(hp.n), participation, state.step, length)
    device = tree_leaves(state.params)[0].device
    losses = torch.empty((length,), dtype=torch.float32, device=device)
    branches = np.empty((length,), np.int32)
    for i in range(length):
        batch = batches if batch_axis is None else \
            tree_map(lambda a: a[i], batches)
        mask = None if masks is None else \
            torch.from_numpy(masks[i]).to(device)
        state, metrics = l2gd_step(
            state, batch, int(xis[i]), subs[i], grad_fn, hp, client_comp,
            master_comp, average_fn, participation_mask=mask,
            axis_name=axis_name, local_steps=local_steps, loss_fn=loss_fn)
        losses[i] = metrics["loss"]
        branches[i] = metrics["branch"]
    return state, RolloutTrace(
        losses=losses, xis=xis, branches=branches,
        n_local=int(np.sum(branches == 0)),
        n_agg_comm=int(np.sum(branches == 1)),
        n_agg_cached=int(np.sum(branches == 2)))


def sharded_state_specs(state: L2GDState, axis_name: str = "clients"
                        ) -> L2GDState:
    """Spec tree of an :class:`L2GDState` sharded over the ``clients``
    axis: ``params`` cut on the leading client axis, the ``cache`` (the
    shared target) and the protocol scalars whole (``launch.sharding``'s
    spec tuples)."""
    return L2GDState(
        params=tree_map(lambda a: (axis_name,) + (None,) * (a.dim() - 1),
                        state.params),
        cache=tree_map(lambda a: (None,) * a.dim(), state.cache),
        xi_prev=(), step=())


def _cut_clients(tree, n: int, m: int, index: int, axis: int):
    """This process's m clients of ``tree``'s client axis ``axis``: a cut
    of the n global clients, or ``tree`` itself when it already holds m
    (a tree placed with ``launch.sharding``)."""
    leaves = tree_leaves(tree)
    if not leaves or leaves[0].shape[axis] == m:
        return tree
    if leaves[0].shape[axis] != n:
        raise ValueError(f"client axis {leaves[0].shape[axis]} is neither "
                         f"n = {n} nor this shard's {m}")
    lo = index * m
    return tree_map(lambda a: a[(slice(None),) * axis + (slice(lo, lo + m),)],
                    tree)


def rollout_l2gd_sharded(key, state: L2GDState, hp: L2GDHyper, batches,
                         xi_trace: Optional[Any] = None, *, mesh,
                         grad_fn: Callable, steps: Optional[int] = None,
                         client_comp=Identity(), master_comp=Identity(),
                         participation: Optional[float] = None,
                         batch_axis: Optional[int] = 0,
                         axis_name: str = "clients", local_steps: int = 1,
                         loss_fn: Optional[Callable] = None):
    """:func:`rollout_l2gd` with the client axis SHARDED over the
    processes of ``mesh``'s ``axis_name`` axis (``launch.mesh.
    make_client_mesh``), SPMD: every process derives the window's xi
    draws, step keys and participation masks on the host exactly as
    :func:`rollout_l2gd` does, then runs the same step loop on its own
    n / n_shards clients.  The fresh branch's exchange is
    :func:`repro_torch.core.aggregation.make_client_sharded_average` (the
    clients' wire payloads ``all_gather``-ed), and the losses are summed
    over the axis in rank order.  On one process at full participation
    the run is :func:`rollout_l2gd`'s bit for bit; on more, params, cache
    and xis still are, the losses to summation order.

    ``state.params`` and ``batches`` hold the n global clients (cut here
    to this process's) or already this process's (placed with
    ``launch.sharding.client_sharded_shardings`` /
    ``client_sharded_batch_shardings``).  Returns ``(final_state,
    RolloutTrace)``: the final params are this process's clients, the
    cache and the trace the same on every process."""
    from repro_torch.core.aggregation import make_client_sharded_average
    from repro_torch.core.collective import MeshAxis
    n = int(hp.n)
    axis = MeshAxis(mesh, axis_name)
    if n % axis.size:
        raise ValueError(f"n={n} clients do not divide the {axis_name!r} "
                         f"mesh axis of size {axis.size}")
    m = n // axis.size
    leaves = tree_leaves(state.params)
    if leaves and leaves[0].shape[0] not in (n, m):
        raise ValueError(f"state.params leading axis {leaves[0].shape[0]} "
                         f"!= hp.n = {n}")
    box = [state._replace(params=_cut_clients(state.params, n, m,
                                              axis.index, 0))]
    del state, leaves
    batches = _cut_clients(batches, n, m, axis.index,
                           0 if batch_axis is None else 1)
    return rollout_l2gd(
        key, box.pop(), hp, batches, xi_trace, grad_fn=grad_fn, steps=steps,
        client_comp=client_comp, master_comp=master_comp,
        batch_axis=batch_axis, participation=participation,
        local_steps=local_steps, loss_fn=loss_fn,
        average_fn=make_client_sharded_average(axis, n, client_comp,
                                               master_comp),
        axis_name=axis)


def rollout_l2gd_grid(key, params_stacked, hp_grid: L2GDHyper, batches,
                      xi_trace: Optional[Any] = None, *, grad_fn: Callable,
                      steps: Optional[int] = None, client_comp=Identity(),
                      master_comp=Identity(), batch_axis: Optional[int] = 0):
    """One rollout per cell of a hyper grid.

    ``hp_grid`` is an :class:`L2GDHyper` whose ``eta``/``lam``/``p`` are
    same-shaped 1-D arrays of G cells (:func:`hyper_grid` or
    :func:`~repro_torch.core.l2gd.make_hyper`); every cell starts from
    ``init_state(params_stacked)``, shares ``key`` (common random
    numbers: each cell's xi draws threshold the same uniforms at its own
    p) and the batches.  Returns ``(final_states, traces)`` with a leading
    G axis on every field: the params and cache trees stacked on the
    device, ``xi_prev`` / ``step`` / ``xis`` / ``branches`` / the counters
    numpy arrays, the losses a (G, K) device tensor."""
    etas, lams, ps = (np.atleast_1d(np.asarray(v, np.float32))
                      for v in (hp_grid.eta, hp_grid.lam, hp_grid.p))
    finals, traces = [], []
    for g in range(etas.shape[0]):
        hp = L2GDHyper(eta=etas[g], lam=lams[g], p=ps[g], n=hp_grid.n)
        final, trace = rollout_l2gd(
            key, init_state(params_stacked), hp, batches, xi_trace,
            grad_fn=grad_fn, steps=steps, client_comp=client_comp,
            master_comp=master_comp, batch_axis=batch_axis)
        finals.append(final)
        traces.append(trace)
    stack = lambda *xs: torch.stack(xs)
    states = L2GDState(
        params=tree_map(stack, *(f.params for f in finals)),
        cache=tree_map(stack, *(f.cache for f in finals)),
        xi_prev=np.asarray([f.xi_prev for f in finals], np.int32),
        step=np.asarray([f.step for f in finals], np.int32))
    return states, RolloutTrace(
        losses=torch.stack([t.losses for t in traces]),
        xis=np.stack([t.xis for t in traces]),
        branches=np.stack([t.branches for t in traces]),
        n_local=np.asarray([t.n_local for t in traces], np.int32),
        n_agg_comm=np.asarray([t.n_agg_comm for t in traces], np.int32),
        n_agg_cached=np.asarray([t.n_agg_cached for t in traces], np.int32))


def hyper_grid(ps, lams, eta, n: int):
    """Flatten a cartesian (p, lambda) product into one array-valued
    :class:`L2GDHyper` for :func:`rollout_l2gd_grid`.

    ``eta`` is a scalar, an array broadcastable to the ``(|ps|, |lams|)``
    meshgrid, or a callable ``(P, L) -> eta`` evaluated on it (e.g. the
    Fig-3 stability rule ``lambda P, L: np.minimum(0.4, n * P / L)``).
    Returns ``(hp_grid, grid_shape)``; reshape per-cell outputs with
    ``out.reshape(grid_shape + out.shape[1:])``."""
    P, L = np.meshgrid(np.asarray(ps, np.float32),
                       np.asarray(lams, np.float32), indexing="ij")
    E = eta(P, L) if callable(eta) else eta
    E = np.broadcast_to(np.asarray(E, np.float32), P.shape)
    hp = make_hyper(eta=E.ravel(), lam=L.ravel(), p=P.ravel(), n=n)
    return hp, P.shape


def state_to_tree(state: L2GDState) -> dict:
    """:class:`L2GDState` as a plain dict tree — the checkpoint form, with
    ``xi_prev`` and ``step`` as 0-d int32 arrays, as the reference's.
    ``step`` is the global step every random stream is keyed by, which
    is why a restored state continues bit for bit."""
    return {"params": state.params, "cache": state.cache,
            "xi_prev": np.asarray(int(state.xi_prev), np.int32),
            "step": np.asarray(int(state.step), np.int32)}


def state_from_tree(tree: dict) -> L2GDState:
    """Inverse of :func:`state_to_tree` (the scalars back to ints)."""
    return L2GDState(params=tree["params"], cache=tree["cache"],
                     xi_prev=int(tree["xi_prev"]), step=int(tree["step"]))
