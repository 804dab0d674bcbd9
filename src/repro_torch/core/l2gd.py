"""Compressed L2GD — Algorithm 1 of the paper, one step at a time; the
counterpart of ``repro.core.l2gd``.

The n personalized models are a stacked tree whose leaves have a leading
client axis n.  Each step takes one of three branches:

  branch 0  (xi_k = 0)                : local gradient step, no communication
  branch 1  (xi_k = 1, xi_{k-1} = 0)  : aggregation with fresh compressed
                                        communication (uplink C_i, downlink C_M)
  branch 2  (xi_k = 1, xi_{k-1} = 1)  : aggregation against the cached
                                        target, no communication

Step scalings follow the paper: local ``eta/(n(1-p)) * grad f_i``,
aggregation ``(eta lam)/(n p) * (x_i - target)``, both computed in
float32 from float32 ``eta``/``lam``/``p`` as the reference computes them
on device.

The xi draws and ``xi_prev`` live on the host, so the branch is chosen
in Python without reading anything back from the device.  ``grad_fn``
takes the stacked params and the stacked batch and returns
``(losses (n,), grads_stacked)`` — the reference's per-client function
under ``vmap``, written out over the client axis; it must return fresh
gradient tensors.  The aggregation branches need only the losses: an
optional ``loss_fn(params, batch) -> losses (n,)`` gives them without a
backward (the reference calls ``grad_fn`` there and XLA removes the dead
backward; eager PyTorch would run it).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.aggregation import client_mean, compressed_average
from repro_torch.core.codec import as_plan
from repro_torch.core.compressors import Identity
from repro_torch.core.tree import tree_map

__all__ = ["L2GDHyper", "L2GDState", "init_state", "make_hyper", "l2gd_step",
           "local_update", "aggregation_update", "draw_xi"]

_F32 = np.float32


@dataclasses.dataclass(frozen=True)
class L2GDHyper:
    """Meta-parameters of Algorithm 1: Python or numpy scalars, or (for a
    grid, :func:`repro_torch.core.rollout.rollout_l2gd_grid`) same-shaped
    numpy arrays, validated elementwise."""

    eta: Any            # stepsize
    lam: Any            # personalization penalty lambda
    p: Any              # aggregation probability
    n: int              # number of clients

    def __post_init__(self):
        p, lam = np.asarray(self.p), np.asarray(self.lam)
        if not bool(np.all((p > 0.0) & (p < 1.0))):
            raise ValueError(f"p must be in (0,1), got {self.p}")
        if not bool(np.all(lam >= 0.0)):
            raise ValueError("lambda must be >= 0")

    @property
    def local_scale(self) -> np.float32:
        return _F32(self.eta) / (_F32(self.n) * (_F32(1.0) - _F32(self.p)))

    @property
    def agg_scale(self) -> np.float32:
        return _F32(self.eta) * _F32(self.lam) / (_F32(self.n) * _F32(self.p))


def make_hyper(eta, lam, p, n: int) -> L2GDHyper:
    """Build helper for (possibly array-valued) hypers: scalars or
    same-shaped arrays for ``eta``/``lam``/``p``, range-checked
    elementwise."""
    return L2GDHyper(eta=eta, lam=lam, p=p, n=int(n))


class L2GDState(NamedTuple):
    params: Any         # stacked client params, leading axis n
    cache: Any          # cached aggregation target (no client axis)
    xi_prev: int        # xi_{k-1}
    step: int           # global step counter


def init_state(params_stacked) -> L2GDState:
    """xi_{-1} = 1 and cache = exact xbar^{-1}, per Algorithm 1's input."""
    return L2GDState(params=params_stacked,
                     cache=tree_map(client_mean, params_stacked),
                     xi_prev=1, step=0)


def local_update(params_stacked, grads_stacked, hp: L2GDHyper):
    """x_i <- x_i - eta/(n(1-p)) grad f_i(x_i), in float32, rounded once
    to the parameter dtype.  The product is formed in a new buffer and the
    difference written over it, so the step holds one model-sized
    temporary, not two."""
    s = float(hp.local_scale)

    def one(x, g):
        step = g.to(torch.float32) * s
        return torch.sub(x.to(torch.float32), step, out=step).to(x.dtype)

    return tree_map(one, params_stacked, grads_stacked)


def aggregation_update(params_stacked, target, hp: L2GDHyper, mask=None):
    """x_i <- x_i - (eta lam)/(n p) (x_i - t); t broadcast over the client
    axis.  ``mask`` (optional (n,) 0/1) gates the update per client.  The
    difference, its scaling and the result share one temporary."""
    c = float(hp.agg_scale)

    def one(x, t):
        xf = x.to(torch.float32)
        diff = xf - t[None].to(torch.float32)
        if mask is None:
            diff.mul_(c)
        else:
            mb = mask.reshape((x.shape[0],) + (1,) * (x.dim() - 1)) \
                .to(torch.float32)
            diff.mul_(mb * c)
        return torch.sub(xf, diff, out=diff).to(x.dtype)

    return tree_map(one, params_stacked, target)


def draw_xi(key, p) -> int:
    """xi ~ Bernoulli(p) from the key's threefry stream."""
    return int(prng.bernoulli(key, p))


def _mean_loss(losses: torch.Tensor) -> torch.Tensor:
    return client_mean(losses.to(torch.float32))


def aggregation_loss(params, batch, grad_fn: Callable,
                     loss_fn: Optional[Callable] = None) -> torch.Tensor:
    """The mean client loss of an aggregation step's pre-update params:
    ``loss_fn`` under ``torch.no_grad``, or ``grad_fn``'s losses (its
    gradients dropped at once)."""
    if loss_fn is None:
        return _mean_loss(grad_fn(params, batch)[0])
    with torch.no_grad():
        return _mean_loss(loss_fn(params, batch))


def l2gd_step(state: L2GDState, batch, xi_k: int, key, grad_fn: Callable,
              hp: L2GDHyper, client_comp=Identity(), master_comp=Identity(),
              *, participation_mask=None, local_steps: int = 1,
              loss_fn: Optional[Callable] = None):
    """One step of Algorithm 1.

    ``xi_k`` is this step's Bernoulli(p) draw (a host int), ``key`` the
    step's compressor key (two uint32 words).  ``participation_mask``
    (optional (n,) 0/1 float32 tensor) is this step's sampled
    participant subset (DESIGN.md §9): only its clients enter the
    average and move in the aggregation update; local steps are
    unaffected; ``None`` is full participation.  ``local_steps`` is the
    LoCoDL burst H >= 1: a local step runs H gradient passes on its
    batch; aggregation steps are unaffected.  ``loss_fn`` (optional)
    gives the aggregation branches' losses under ``torch.no_grad``.

    Returns ``(new_state, {"loss": mean client loss at the PRE-update
    params (a 0-d device tensor), "branch": 0 | 1 | 2})``."""
    if not isinstance(local_steps, int) or local_steps < 1:
        raise ValueError(f"local_steps must be an int >= 1, got {local_steps}")
    branch = 0 if int(xi_k) == 0 else (1 if state.xi_prev == 0 else 2)
    if branch == 0:
        losses, grads = grad_fn(state.params, batch)
        new_params = local_update(state.params, grads, hp)
        del grads
        for _ in range(local_steps - 1):
            _, grads = grad_fn(new_params, batch)
            new_params = local_update(new_params, grads, hp)
            del grads
        new_state = L2GDState(new_params, state.cache, 0, state.step + 1)
        return new_state, {"loss": _mean_loss(losses), "branch": 0}
    # aggregation: the loss of the pre-update params; without a loss_fn
    # the gradients of this evaluation are dropped before the aggregation
    # allocates
    loss = aggregation_loss(state.params, batch, grad_fn, loss_fn)
    if branch == 1:
        target = compressed_average(key, state.params, as_plan(client_comp),
                                    as_plan(master_comp),
                                    mask=participation_mask)
    else:
        target = state.cache
    new_params = aggregation_update(state.params, target, hp,
                                    mask=participation_mask)
    new_state = L2GDState(new_params, target, 1, state.step + 1)
    return new_state, {"loss": loss, "branch": branch}
