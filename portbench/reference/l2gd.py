"""Compressed L2GD's three branches, written out plainly: the reference
follows the program's whole run, its first steps and its timed window,
from the same weights, tokens, branch draws and keys.

  local  (xi = 0):            x_i <- x_i - eta / (n (1 - p)) grad f_i(x_i)
  fresh  (xi = 1 after 0):    t = C_M(mean_i C_i(x_i)), cached;
                              x_i <- x_i - eta lam / (n p) (x_i - t)
  cached (xi = 1 after 1):    the same pull toward the cached t

The scalings are float32 numbers formed in float32; a step's loss is the
mean of the clients' losses at the parameters it starts from, each by
the configuration's plain model (its ``loss``, which the caller hands
in).  The cache starts as the exact mean of the initial models
(xi_{-1} = 1).
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import codecs

_F32 = np.float32


def scales(eta: float, lam: float, p: float, n: int) -> tuple:
    local = _F32(eta) / (_F32(n) * (_F32(1.0) - _F32(p)))
    agg = _F32(eta) * _F32(lam) / (_F32(n) * _F32(p))
    return float(local), float(agg)


def client_mean(a: torch.Tensor) -> torch.Tensor:
    acc = a[0].clone()
    for i in range(1, a.shape[0]):
        acc += a[i]
    return acc * codecs.mean_scale(a.shape[0])


def pair_norms(a: dict, b: dict, scale: float = 1.0) -> np.ndarray:
    """(n, leaves) float64 norms of ``(a - b) / scale`` client by client,
    the leaves in sorted name order."""
    names = sorted(a)
    n = a[names[0]].shape[0]
    out = np.zeros((n, len(names)))
    for j, name in enumerate(names):
        for i in range(n):
            diff = a[name][i] - b[name][i]
            out[i, j] = float(torch.linalg.vector_norm(diff.reshape(-1),
                                                       dtype=torch.float64))
            del diff
    return out / scale


def follow(loss, cfg: dict, cell: dict, x0: dict, batches: list, xis: list,
           keys, prologue: int, fault: str = None) -> dict:
    """Run ``len(xis)`` steps of the model whose loss is ``loss(cfg,
    params, tokens, half_batch)`` from the stacked weights ``x0`` (left
    unchanged) on step batches of tokens (n, B, S): the ``prologue``
    steps and then the window's.  Returns every step's loss, the first
    step's gradient norms (n, leaves) worked out from the parameters
    after it, the norms of the change after the prologue and after the
    last step, the cached target at the end ({name: leaf}) and the fresh
    rounds of the window.  ``fault``: "half_batch" (the loss over half
    the positions), "no_exchange" (client 0's message in place of the
    mean), "stale_key" (every fresh round draws with the first one's
    key) or "frozen_window" (the window's steps update nothing)."""
    names = sorted(x0)
    n = x0[names[0]].shape[0]
    local, agg = scales(cell["eta"], cell["lam"], cell["p"], n)
    half = fault == "half_batch"
    x = {k: v.clone() for k, v in x0.items()}
    cache = {k: client_mean(v) for k, v in x0.items()}
    xi_prev, losses, grad_norms, first_key, rounds = 1, [], None, None, 0
    out = {}
    for step, (xi, key, tokens) in enumerate(zip(xis, keys, batches)):
        frozen = fault == "frozen_window" and step >= prologue
        if xi == 0:
            vals = []
            for i in range(n):
                own = {k: v[i].detach().requires_grad_() for k, v in x.items()}
                with torch.enable_grad():
                    value = loss(cfg, own, tokens[i], half_batch=half)
                    grads = torch.autograd.grad(value, [own[k] for k in names])
                vals.append(value.detach())
                del own
                with torch.no_grad():
                    for k, g in zip(names, grads):
                        if not frozen:
                            x[k][i].sub_(g * local)
                del grads
        else:
            with torch.no_grad():
                vals = [loss(cfg, {k: v[i] for k, v in x.items()},
                                   tokens[i], half_batch=half)
                        for i in range(n)]
                if xi_prev == 0:
                    rounds += step >= prologue
                    first_key = key if first_key is None else first_key
                if xi_prev == 0 and not frozen:
                    target = codecs.compressed_average(
                        cell["codec"], cell["transport"],
                        first_key if fault == "stale_key" else key,
                        [x[k] for k in names], fault=fault)
                    cache = dict(zip(names, target))
                    del target
                for k in [] if frozen else names:
                    diff = x[k] - cache[k]
                    diff.mul_(agg)
                    x[k].sub_(diff)
                    del diff
        losses.append(float(client_mean(torch.stack(vals).float())))
        if step == 0 and xi == 0:
            grad_norms = pair_norms(x0, x, local)
        if step + 1 == prologue:
            out["change_norms"] = pair_norms(x, x0)
        xi_prev = int(xi)
    return {**out, "losses": losses, "grad_norms": grad_norms,
            "window_change_norms": pair_norms(x, x0), "cache": cache,
            "rounds": rounds}
