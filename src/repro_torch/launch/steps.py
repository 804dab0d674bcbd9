"""Step builders — the counterpart of ``repro.launch.steps`` for one
process.

  train    -> compressed-L2GD train step (Algorithm 1's three branches,
              the aggregation branch carrying the compressed exchange)
  rollout  -> ``length`` steps of Algorithm 1 in one call
  prefill  -> full-sequence forward, last-position logits (only the last
              position is unembedded: the (B, S, V) logits never exist)
  decode   -> one-token decode against the KV caches (updated in place)

The train builders take the reference's defaults: leafwise plans for both
links (leafwise QSGD and natural run one kernel launch per leaf and
link), ready CompressionPlans passed through.  The clients' gradient is
autograd of ``models.loss_fn`` for one client after another over the
stacked parameter tree (the reference's ``vmap`` of ``value_and_grad``);
the aggregation branches evaluate the loss without a backward.  The
serve builders run without autograd.  ``build_async_rollout_fn`` is the
LM face of the async fault engine; ``checkpointed_rollout`` commits a
built rollout's returned carries to a checkpoint manager.  The uplink may be a heterogeneous
fleet (a FleetPlan or a per-client plan vector, DESIGN.md §13).  The
shard_map ``average_fn`` variants and the sharded rollouts are not ported
yet (ROADMAP.md Queue 1).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.codec import CompressionPlan, make_plan
from repro_torch.core.compressors import Identity
from repro_torch.core.l2gd import L2GDHyper, L2GDState, l2gd_step
from repro_torch.core.rollout import rollout_l2gd
from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.fl.fleet import FleetPlan, fleet_from_plans, resolve_uplink
from repro_torch.models import blocks, decode_step, hidden, init_params
from repro_torch.models import loss_fn as model_loss_fn

__all__ = ["param_shapes", "stacked_param_shapes", "stacked_grad_fn",
           "stacked_loss_fn", "build_train_step", "build_rollout_fn",
           "build_async_rollout_fn", "checkpointed_rollout",
           "build_prefill_step", "build_serve_step"]


def param_shapes(cfg: ArchConfig):
    """One model's parameter tree on the ``meta`` device (shapes only)."""
    return init_params(None, cfg, device="meta")


def stacked_param_shapes(cfg: ArchConfig, n_clients: int):
    """The client-stacked parameter tree on the ``meta`` device."""
    return tree_map(lambda a: torch.empty((n_clients,) + tuple(a.shape),
                                          dtype=a.dtype, device="meta"),
                    param_shapes(cfg))


def _client(tree, i: int):
    return tree_map(lambda a: a[i], tree)


def stacked_grad_fn(cfg: ArchConfig):
    """``grad_fn(params, batch) -> (losses (n,), grads)`` over the stacked
    client axis: client i's loss and its autograd gradient, the clients
    one after another, each client's graph freed before the next starts.
    The gradients are fresh stacked tensors."""

    def grad_fn(params, batch):
        leaves, treedef = tree_flatten(params)
        n = leaves[0].shape[0]
        grads = [torch.empty_like(a) for a in leaves]
        losses = torch.empty((n,), dtype=torch.float32,
                             device=leaves[0].device)
        for i in range(n):
            own = [a[i].detach().requires_grad_() for a in leaves]
            with torch.enable_grad():
                loss, _ = model_loss_fn(tree_unflatten(treedef, own), cfg,
                                        _client(batch, i))
                got = torch.autograd.grad(loss, own)
            losses[i] = loss.detach()
            for dst, g in zip(grads, got):
                dst[i].copy_(g)
            del own, loss, got
        return losses, tree_unflatten(treedef, grads)

    return grad_fn


def stacked_loss_fn(cfg: ArchConfig):
    """``loss_fn(params, batch) -> losses (n,)``: the clients' losses
    without autograd (the aggregation branches')."""

    @torch.no_grad()
    def loss_fn(params, batch):
        n = tree_flatten(params)[0][0].shape[0]
        return torch.stack([
            model_loss_fn(_client(params, i), cfg, _client(batch, i))[0]
            .to(torch.float32) for i in range(n)])

    return loss_fn


def _uplink_plan(client_comp, shapes):
    """Plain compressors get the builders' leafwise default, ready
    CompressionPlans pass through (bound if needed), and a FleetPlan
    binds every cohort to the model's shapes and unwraps if uniform; a
    length-n sequence is a per-client plan vector (deduped into
    cohorts, the same rule)."""
    if isinstance(client_comp, (list, tuple)):
        client_comp = fleet_from_plans(client_comp)
    if isinstance(client_comp, FleetPlan):
        return resolve_uplink(client_comp.bind(shapes))
    if isinstance(client_comp, CompressionPlan):
        return client_comp if client_comp.specs is not None \
            else client_comp.bind(shapes)
    return make_plan(client_comp, shapes, transport="leafwise")


def _plans(cfg, client_comp, master_comp, average_fn, plans):
    if average_fn is not None:
        raise NotImplementedError(
            "average_fn (the shard_map aggregation variants) comes with the "
            "multi-device launch slice of the port")
    if plans is not None:
        return tuple(plans)
    shapes = param_shapes(cfg)
    return (_uplink_plan(client_comp, shapes),
            make_plan(master_comp, shapes, transport="leafwise"))


def build_train_step(cfg: ArchConfig, hp: L2GDHyper,
                     client_comp=Identity(), master_comp=Identity(),
                     average_fn=None, plans=None):
    """Compressed-L2GD step over client-stacked model params.
    ``plans`` (optional) is an (uplink, downlink) pair of
    CompressionPlans; by default both compressors get leafwise plans.

    Returns ``train_step(state, batch, xi, key) -> (state, metrics)``
    with ``xi`` this step's host draw (0 or 1) and ``key`` its
    compressor key (two uint32 words)."""
    up_plan, down_plan = _plans(cfg, client_comp, master_comp, average_fn,
                                plans)
    grad_fn, loss_fn = stacked_grad_fn(cfg), stacked_loss_fn(cfg)

    def train_step(state: L2GDState, batch, xi, key):
        return l2gd_step(state, batch, int(xi), key, grad_fn, hp, up_plan,
                         down_plan, loss_fn=loss_fn)

    return train_step


def build_rollout_fn(cfg: ArchConfig, hp: L2GDHyper,
                     client_comp=Identity(), master_comp=Identity(),
                     average_fn=None, plans=None, length: int = 8,
                     local_steps: int = 1):
    """``length`` rounds of Algorithm 1 in one call, xi drawn from the
    key (:func:`repro_torch.core.rollout.rollout_l2gd`); the plan rules
    of :func:`build_train_step`.  Returns ``rollout(state, batches,
    key) -> (state, RolloutTrace)`` with batches stacked over a leading
    (length, ...) steps axis; the host replays ``trace.xis`` into the
    bits ledger."""
    up_plan, down_plan = _plans(cfg, client_comp, master_comp, average_fn,
                                plans)
    grad_fn, loss_fn = stacked_grad_fn(cfg), stacked_loss_fn(cfg)

    def rollout(state: L2GDState, batches, key):
        return rollout_l2gd(key, state, hp, batches, grad_fn=grad_fn,
                            steps=length, client_comp=up_plan,
                            master_comp=down_plan, local_steps=local_steps,
                            loss_fn=loss_fn)

    return rollout


def build_async_rollout_fn(cfg: ArchConfig, hp: L2GDHyper, fault_plan=None,
                           client_comp=Identity(), master_comp=Identity(),
                           plans=None, length: int = 8):
    """:func:`build_rollout_fn`'s face of the async fault engine
    (:func:`repro_torch.core.async_engine.rollout_l2gd_async`): ``length``
    faulty steps a call, the fault events drawn from the plan's fourth
    stream (``fault_plan=None`` is the null plan).  Returns
    ``rollout(state, agg, batches, key) -> (state, agg,
    AsyncRolloutTrace)``: it threads the L2GDState and the server's delay
    buffer (build the first with :func:`repro_torch.core.async_engine.
    init_async_state`; both are consumed); the host replays ``trace.xis``
    and ``trace.events`` into the ledger
    (:meth:`repro_torch.fl.ledger.BitsLedger.replay_fault_trace`)."""
    from repro_torch.core.async_engine import rollout_l2gd_async
    from repro_torch.fl.faults import FaultPlan
    if fault_plan is None:
        fault_plan = FaultPlan()
    up_plan, down_plan = _plans(cfg, client_comp, master_comp, None, plans)
    grad_fn, loss_fn = stacked_grad_fn(cfg), stacked_loss_fn(cfg)

    def rollout(state: L2GDState, agg, batches, key):
        return rollout_l2gd_async(key, state, hp, batches, grad_fn=grad_fn,
                                  fault_plan=fault_plan, steps=length,
                                  client_comp=up_plan, master_comp=down_plan,
                                  agg_state=agg, loss_fn=loss_fn)

    return rollout


def checkpointed_rollout(rollout_fn, manager, *, length: int,
                         every: int = 1, start_step: int = 0,
                         wait: bool = False):
    """Wrap a built rollout function with checkpoint commits.

    Takes both carry shapes: :func:`build_rollout_fn`'s ``(state,
    batches, key) -> (state, trace)`` and :func:`build_async_rollout_fn`'s
    ``(state, agg, batches, key) -> (state, agg, trace)``.  Every
    ``every``-th call, the RETURNED carries are committed to ``manager``
    (a :class:`repro_torch.checkpoint.CheckpointManager` or a root
    directory) under the step count ``start_step + calls * length``;
    ``save`` blocks only for the copy to the host.  The wrapper exposes
    ``.step``, ``.dispatches`` and ``.manager`` and passes the rollout's
    output through unchanged."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.rollout import state_to_tree
    if not isinstance(manager, CheckpointManager):
        manager = CheckpointManager(str(manager))
    if int(every) < 1:
        raise ValueError(f"every must be >= 1, got {every}")

    def wrapper(*args):
        out = rollout_fn(*args)
        wrapper.step += int(length)
        wrapper.dispatches += 1
        if wrapper.dispatches % every == 0:
            tree = {"state": state_to_tree(out[0])}
            if len(out) == 3:            # the async engine: agg carry too
                from repro_torch.core.async_engine import agg_state_to_tree
                tree["agg"] = agg_state_to_tree(out[1])
            manager.save(wrapper.step, tree, wait=wait)
        return out

    wrapper.step = int(start_step)
    wrapper.dispatches = 0
    wrapper.manager = manager
    return wrapper


def build_prefill_step(cfg: ArchConfig):
    """``prefill_step(params, batch) -> (B, V)`` last-position logits;
    ``batch`` carries the stub ``patches`` (vision) or ``frames``
    (encoder-decoder) beside the tokens, as ``forward`` takes them."""
    @torch.no_grad()
    def prefill_step(params, batch):
        x = hidden(params, cfg, batch)
        return blocks.unembed(params["embed"], x[:, -1])
    return prefill_step


def build_serve_step(cfg: ArchConfig):
    """``serve_step(params, caches, index, batch) -> ((B, V) logits,
    caches)``: one token a sequence (``batch["tokens"]`` (B, 1)); the
    encoder-decoder reads its cross caches, which the caller filled."""
    @torch.no_grad()
    def serve_step(params, caches, index, batch):
        logits, new_caches = decode_step(params, cfg, caches, index, batch)
        return logits[:, 0], new_caches
    return serve_step
