"""Minimal functional optimizers — the counterpart of ``repro.optim``.

L2GD's local step IS plain (scaled) gradient descent — the algorithm's
update rules live in :mod:`repro_torch.core.l2gd`.  These optimizers
serve the baselines: client-side SGD for FedAvg local epochs and
server-side Adam for FedOpt, plus schedules for the end-to-end training
example.  They are plain functions on trees of tensors (not
``torch.optim``), and each expression is the reference's, operation for
operation, in float32: Python constants enter as float32 scalars, as a
weakly typed constant does in JAX.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves, tree_map

__all__ = ["sgd_init", "sgd_update", "adam_init", "adam_update",
           "cosine_schedule", "AdamState"]


def _f32(c) -> float:
    """A Python constant as the float32 value JAX computes it with."""
    return float(np.float32(c))


def sgd_init(params, momentum: float = 0.0):
    if momentum == 0.0:
        return None
    return tree_map(torch.zeros_like, params)


def sgd_update(params, grads, state, lr: float, momentum: float = 0.0):
    if momentum == 0.0:
        new = tree_map(lambda p, g: p - _f32(lr) * g.to(p.dtype), params,
                       grads)
        return new, None
    vel = tree_map(lambda v, g: _f32(momentum) * v + g.to(v.dtype), state,
                   grads)
    new = tree_map(lambda p, v: p - _f32(lr) * v, params, vel)
    return new, vel


class AdamState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor     # int32 0-d tensor on the params' device


def adam_init(params) -> AdamState:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    z = lambda: tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
    return AdamState(z(), z(), torch.zeros((), dtype=torch.int32,
                                           device=device))


def adam_update(params, grads, state: AdamState, lr: float, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8):
    """One Adam step.  The bias corrections are float32 powers of the
    float32 betas at the int32 count converted to float32, as the
    reference computes them."""
    c = state.count + 1
    mu = tree_map(lambda m, g: _f32(b1) * m
                  + _f32(1 - b1) * g.to(torch.float32), state.mu, grads)
    nu = tree_map(lambda v, g: _f32(b2) * v
                  + _f32(1 - b2) * torch.square(g.to(torch.float32)),
                  state.nu, grads)
    cf = c.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(_f32(b1), device=cf.device), cf)
    bc2 = 1 - torch.pow(torch.tensor(_f32(b2), device=cf.device), cf)
    new = tree_map(
        lambda p, m, v: p - (_f32(lr) * (m / bc1)
                             / (torch.sqrt(v / bc2) + _f32(eps))).to(p.dtype),
        params, mu, nu)
    return new, AdamState(mu, nu, c)


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to 0 at ``total``; ``lr_at(step)`` is a float32 0-d tensor."""
    def lr_at(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = _f32(base_lr) * step / max(warmup, 1)
        frac = torch.clip((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = _f32(0.5 * base_lr) * (1.0 + torch.cos(_f32(math.pi) * frac))
        return torch.where(step < warmup, warm, cos)
    return lr_at
