"""FedAvg baseline — including the paper's compressed-difference schema;
the counterpart of ``repro.fl.fedavg``.

Vanilla FedAvg [McMahan et al. 2017]: every round, each client runs E local
SGD epochs from the global model, the server averages the resulting models.

The paper's compression add-on (§VII, 'Algorithms used for comparison'),
an error-feedback-style memory:

  (i)   after local steps the client forms the direction
        g_computed^i = x_global - x_local_new  (the model delta);
  (ii)  it sends the compressed innovation C(g_computed^i - g^{i-1});
  (iii) both client and master update g^i = g^{i-1} + C(g_computed^i - g^{i-1}).

The server then applies the average of the g^i.  FedOpt (fedopt.py) swaps
the server update for Adam.  Each client's compression key is ``key,
sub = split(key)``, once per client and round in client order; the ledger
charges ``up_plan.round_bits()`` up and ``down_plan.round_bits()`` down
per round.

A client's innovation, compressed innovation and local model are freed
before the next client starts, so the server holds the global model, the
n memories and one client's work at a time.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.codec import CompressionPlan, make_plan
from repro_torch.core.compressors import Identity
from repro_torch.core.tree import tree_map
from repro_torch.fl.ledger import BitsLedger
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.optim import adam_init, adam_update

__all__ = ["FedRun", "run_fedavg", "local_sgd_epochs"]


@dataclasses.dataclass
class FedRun:
    params: object               # final global model
    ledger: BitsLedger
    losses: list                 # (round, mean client loss)
    evals: list


def local_sgd_epochs(params, grad_fn, batches, lr: float):
    """Run SGD over a list of per-step batches; returns (params, mean
    loss).  ``params`` is not modified."""
    lr32 = float(np.float32(lr))
    total = 0.0
    for b in batches:
        loss, grads = grad_fn(params, b)
        params = tree_map(lambda p, g: p - lr32 * g.to(p.dtype), params,
                          grads)
        del grads
        total += float(loss)
    return params, total / max(len(batches), 1)


def _up_plan(compressor, global_params) -> CompressionPlan:
    """The uplink plan: the compressor's auto plan over the global model
    (the reference's), or a ready CompressionPlan (bound if needed) —
    a leafwise QSGD plan, say, which the reference's run_fedavg cannot
    take."""
    comp = compressor if compressor is not None else Identity()
    if isinstance(comp, CompressionPlan):
        return comp if comp.specs is not None else comp.bind(global_params)
    return make_plan(comp, global_params)


def _fold(acc, tree):
    """``acc + tree`` in acc's buffers (a new tree when acc is None): the
    reference's ``sum(xs)`` folds from 0, and ``0 + x`` makes -0.0 +0.0."""
    if acc is None:
        return tree_map(lambda x: 0 + x, tree)
    tree_map(lambda a, x: a.add_(x), acc, tree)
    return acc


def run_fedavg(key, global_params, grad_fn: Callable,
               client_batches_fn: Callable[[int, int], list],
               n_clients: int, rounds: int, local_lr: float,
               compressor=None, server: str = "avg", server_lr: float = 1.0,
               eval_fn: Optional[Callable] = None, eval_every: int = 10,
               local_steps_jit: bool = True, device=None) -> FedRun:
    """FedAvg (``server="avg"``) or FedOpt (``server="adam"``) on
    ``device`` (default ``cuda``; raises without a CUDA device unless one
    is named).

    ``grad_fn(params, batch) -> (loss, grads)`` is one client's (no
    client axis); ``client_batches_fn(round, client)`` the client's list
    of local batches for the round.  ``compressor=None`` sends exact
    deltas (the paper's no-compression baselines); a compressor or a
    CompressionPlan compresses the innovation against the client's
    memory.  ``local_steps_jit`` is accepted for the reference's
    signature and has no effect (there is nothing to jit)."""
    del local_steps_jit
    if server not in ("avg", "adam"):
        raise ValueError(f"server must be 'avg' or 'adam', got {server!r}")
    device = resolve_device(device)
    key = np.asarray(key, np.uint32)
    params = tree_map(lambda a: torch.as_tensor(a).to(device), global_params)
    del global_params
    ledger = BitsLedger(n_clients)
    run = FedRun(params, ledger, [], [])
    comp = compressor
    memory = None  # per-client EF memory g^{i-1}
    if comp is not None:
        memory = [tree_map(torch.zeros_like, params)
                  for _ in range(n_clients)]
    opt_state = adam_init(params) if server == "adam" else None
    del params
    # plans built once over the global model; the ledger reads the
    # payload spec (plan.round_bits(), DESIGN.md §3)
    up_plan = _up_plan(comp, run.params)
    down_plan = make_plan(Identity(), run.params)  # uncompressed bcast
    up_bits = up_plan.round_bits()
    down_bits = down_plan.round_bits()
    slr = float(np.float32(server_lr))
    n_dev = torch.tensor(float(n_clients), device=device)

    def to_device(batch):
        return tree_map(lambda a: torch.as_tensor(a).to(device), batch)

    for r in range(rounds):
        acc, losses = None, []   # the sum of the clients' deltas
        for i in range(n_clients):
            batches = [to_device(b) for b in client_batches_fn(r, i)]
            p_i, loss_i = local_sgd_epochs(run.params, grad_fn, batches,
                                           local_lr)
            del batches
            losses.append(loss_i)
            delta = tree_map(lambda g, l: g - l, run.params, p_i)
            del p_i
            if comp is not None:
                key, sub = prng.split(key)
                # the innovation is formed in the delta's buffers
                innov = tree_map(lambda d, m: d.sub_(m), delta, memory[i])
                del delta
                c_innov = up_plan.apply(sub, innov)
                del innov
                tree_map(lambda m, c: m.add_(c), memory[i], c_innov)
                del c_innov
                continue
            acc = _fold(acc, delta)     # an exact delta is folded at once
            del delta
        if comp is not None:            # the memories are the deltas
            for m in memory:
                acc = _fold(acc, m)
        # a division by a device scalar: CUDA would multiply by the
        # reciprocal of a Python number, the reference divides
        avg_delta = tree_map(lambda a: a.div_(n_dev), acc)
        del acc
        if server == "adam":
            run.params, opt_state = adam_update(run.params, avg_delta,
                                                opt_state, server_lr)
        else:
            run.params = tree_map(lambda p, d: p - slr * d, run.params,
                                  avg_delta)
        del avg_delta
        ledger.record_round(up_bits, down_bits, step=r)
        run.losses.append((r, sum(losses) / n_clients))
        if eval_fn is not None and (r + 1) % eval_every == 0:
            run.evals.append((r, float(eval_fn(run.params))))
    return run
