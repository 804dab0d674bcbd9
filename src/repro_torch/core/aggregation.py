"""The compressed aggregation layer — the counterpart of the stacked half
of ``repro.core.aggregation`` (Algorithm 1's master/worker exchange):

  1. every client i compresses its model:      c_i = C_i(x_i)
  2. the master averages compressed models:    ybar = (1/n) sum_j c_j
  3. the master compresses the average:        t = C_M(ybar)

Flat-engine uplinks encode all n clients in one batched pack launch and
the master forms the mean with the one-pass fused decode->reduce, O(d)
server state (DESIGN.md §10).  Leafwise uplinks apply the plan to the
stacked tree with the n client keys at once: one codec call per leaf,
each client drawing from its own key.  The key schedule is the
reference's: ``k_clients, k_master = split(key)``, client i uses
``split(k_clients, n)[i]``, and a leafwise plan splits that key over the
leaves.  A mixed :class:`repro_torch.fl.fleet.FleetPlan` uplink (DESIGN.md
§13) groups the clients by cohort (:func:`repro_torch.fl.fleet.
fleet_mean`); a uniform fleet unwraps to its plan first.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import flatbuf, prng
from repro_torch.core.codec import CompressionPlan, as_plan
from repro_torch.core.tree import tree_leaves, tree_map

__all__ = ["compressed_average", "masked_client_mean",
           "stacked_finite_mask", "weighted_client_sum", "client_mean",
           "all_finite"]


def _resolve_uplink(comp, transport=None):
    """Uplink coercion: plans pass through, plain compressors take
    ``as_plan``, uniform fleets unwrap to their plan, mixed fleets stay
    fleets.  The fl import happens at call time: ``repro_torch.fl``
    imports this package."""
    if isinstance(comp, CompressionPlan):
        return comp
    from repro_torch.fl.fleet import resolve_uplink
    return resolve_uplink(comp, transport)


def client_mean(a: torch.Tensor) -> torch.Tensor:
    """Mean over the leading client axis as the reference's ``jnp.mean``
    compiles: clients added in index order 0..n-1, the sum multiplied by
    the float32 reciprocal of n (XLA's form of a division by a constant).
    No clients give NaN, as 0 * inf does there."""
    if a.shape[0] == 0:
        return torch.full(a.shape[1:], float("nan"), dtype=a.dtype,
                          device=a.device)
    acc = a[0].clone()
    for i in range(1, a.shape[0]):
        acc += a[i]
    return acc * float(np.float32(1.0 / a.shape[0]))


def masked_client_mean(tree_stacked, mask):
    """Mean over the leading client axis restricted to ``mask``'s
    participants: ``sum_i m_i x_i / sum_i m_i``; ``mask=None`` is the
    plain mean."""
    if mask is None:
        return tree_map(client_mean, tree_stacked)
    denom = torch.sum(mask.to(torch.float32))

    def one(a):
        mb = mask.reshape((a.shape[0],) + (1,) * (a.dim() - 1)).to(a.dtype)
        return torch.sum(a * mb, dim=0) / denom.to(a.dtype)

    return tree_map(one, tree_stacked)


def stacked_finite_mask(tree_stacked) -> torch.Tensor:
    """(n,) 0/1 float32: 1 where client i's slice is finite in EVERY leaf."""
    leaves = tree_leaves(tree_stacked)
    if not leaves:
        return torch.ones((0,), dtype=torch.float32)
    ok = torch.ones((leaves[0].shape[0],), dtype=torch.bool,
                    device=leaves[0].device)
    for a in leaves:
        ok = ok & torch.isfinite(a.to(torch.float32)) \
            .reshape(a.shape[0], math.prod(a.shape[1:])).all(dim=1)
    return ok.to(torch.float32)


def all_finite(fin: torch.Tensor) -> torch.Tensor:
    """0-d bool on ``fin``'s device: every client's 0/1 finite flag is 1
    (True for no clients, as the reference's ``jnp.bool_(True)``)."""
    if fin.shape[0] == 0:
        return torch.ones((), dtype=torch.bool, device=fin.device)
    return torch.min(fin) > 0


def weighted_client_sum(tree_stacked, weights: torch.Tensor):
    """NaN-safe ``sum_i w_i * x_i`` over the leading client axis: clients
    with zero weight are excluded by a select, since NaN * 0 is NaN."""

    def one(a):
        wb = weights.reshape((a.shape[0],) + (1,) * (a.dim() - 1)) \
            .to(a.dtype)
        return torch.sum(torch.where(wb > 0, a, torch.zeros_like(a)) * wb,
                         dim=0)

    return tree_map(one, tree_stacked)


def compressed_average(key, params_stacked, client_comp, master_comp, *,
                       mask=None):
    """t = C_M((1/n) sum_j C_j(x_j)) for stacked client params.

    ``client_comp`` / ``master_comp`` are CompressionPlans or plain
    compressors (auto transport); ``client_comp`` may also be a
    :class:`repro_torch.fl.fleet.FleetPlan` (per-cohort uplinks).
    ``mask`` (optional (n,) 0/1 tensor) restricts the mean to a
    participant subset."""
    up_plan = _resolve_uplink(client_comp)
    down_plan = as_plan(master_comp)
    n = tree_leaves(params_stacked)[0].shape[0]
    k_clients, k_master = prng.split(key)
    client_keys = prng.split(k_clients, n)
    if not isinstance(up_plan, CompressionPlan):
        from repro_torch.fl.fleet import fleet_mean
        if up_plan.n_clients != n:
            raise ValueError(f"fleet covers {up_plan.n_clients} clients; "
                             f"params are stacked for {n}")
        ybar = fleet_mean(up_plan, client_keys, params_stacked, mask)
    elif up_plan.transport in ("flat", "packed"):
        payload = up_plan.encode(client_keys, params_stacked)
        ybar = flatbuf.reduce_payload_mean(payload, mask)
    else:
        # leafwise uplink: the n clients' codecs in one call per leaf.
        # Non-finite clients leave the mean; the plain mean is selected
        # when all are finite, so that path stays the reference's
        compressed = up_plan.apply(client_keys, params_stacked)
        fin = stacked_finite_mask(compressed)
        all_ok = all_finite(fin)
        w = fin if mask is None else mask.reshape(-1).to(torch.float32) * fin
        denom = torch.sum(w)
        safe = torch.where(denom > 0, denom, torch.ones_like(denom))
        guarded = tree_map(lambda s: s / safe.to(s.dtype),
                           weighted_client_sum(compressed, w))
        plain = masked_client_mean(compressed, mask)
        ybar = tree_map(lambda p, g: torch.where(all_ok, p, g), plain,
                        guarded)
        # the clients' compressed models leave before the downlink runs
        del compressed, guarded, plain
    return down_plan.apply(k_master, ybar)
