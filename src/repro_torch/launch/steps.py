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
fleet (a FleetPlan or a per-client plan vector, DESIGN.md §13).

The multi-process builders run SPMD on ``torch.distributed`` (``launch.
mesh``): ``build_average_fn`` gives the per-shard ``average_fn`` hooks
(a bfloat16 uplink, or a plan's packed payload on the all_gather), and
``build_sharded_rollout_fn`` the client-sharded engine on a 1-D
``clients`` mesh or the 2-D engine on a ``(clients, model)`` mesh
(:func:`build_sharded_rollout_fn`).  ``input_specs`` / ``state_specs`` /
``cache_specs`` give every input's shapes on the ``meta`` device.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core.codec import CompressionPlan, make_plan
from repro_torch.core.collective import (MeshAxis, ModelSplit, block_of,
                                         gather_blocks, whole_of)
from repro_torch.core.compressors import Identity
from repro_torch.core.l2gd import L2GDHyper, L2GDState, l2gd_step
from repro_torch.core.rollout import rollout_l2gd
from repro_torch.core.tree import (tree_flatten, tree_leaves, tree_map,
                                   tree_unflatten)
from repro_torch.fl.fleet import FleetPlan, fleet_from_plans, resolve_uplink
from repro_torch.models import (blocks, decode_step, hidden, init_caches,
                                init_params)
from repro_torch.models import loss_fn as model_loss_fn
from repro_torch.models.model import (gathered_leaves, layer_stacks,
                                      model_shards)

__all__ = ["param_shapes", "stacked_param_shapes", "stacked_grad_fn",
           "stacked_loss_fn", "lacks_remat", "model_dims", "split_gathers",
           "input_specs", "state_specs",
           "cache_specs", "build_train_step", "build_rollout_fn", "build_async_rollout_fn",
           "build_sharded_rollout_fn", "build_average_fn",
           "checkpointed_rollout", "build_prefill_step", "build_serve_step"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: InputShape, n_clients: int) -> dict:
    """The batch of one step of ``shape.kind`` as ``meta`` tensors: train
    batches stacked over n clients (``global_batch // n`` sequences
    each), prefill (B, S), decode (B, 1); the vision prefix's patches
    take P of the S positions, the encoder-decoder's frames ride beside
    the tokens."""
    cdt = _DTYPES[cfg.compute_dtype]
    i32 = torch.int32
    if shape.kind == "decode":
        return {"tokens": _meta((shape.global_batch, 1), i32)}
    if shape.kind == "train":
        per = shape.global_batch // n_clients
        if per < 1:
            raise ValueError(f"{shape.name}: global batch "
                             f"{shape.global_batch} < {n_clients} clients")
        lead = (n_clients, per)
    else:
        lead = (shape.global_batch,)
    s = shape.seq_len
    batch = {}
    if cfg.frontend == "vision":
        p = cfg.n_frontend_tokens
        batch["patches"] = _meta(lead + (p, cfg.d_model), cdt)
        batch["tokens"] = _meta(lead + (s - p,), i32)
    elif cfg.is_encdec:
        batch["frames"] = _meta(lead + (cfg.n_frontend_tokens, cfg.d_model),
                                cdt)
        batch["tokens"] = _meta(lead + (s,), i32)
    else:
        batch["tokens"] = _meta(lead + (s,), i32)
    return batch


def state_specs(cfg: ArchConfig, n_clients: int) -> L2GDState:
    """The train state's shapes on the ``meta`` device: stacked params,
    the cache (one model), and the protocol scalars as 0-d int32."""
    params = stacked_param_shapes(cfg, n_clients)
    return L2GDState(params=params,
                     cache=tree_map(lambda a: _meta(a.shape[1:], a.dtype),
                                    params),
                     xi_prev=_meta((), torch.int32),
                     step=_meta((), torch.int32))


def cache_specs(cfg: ArchConfig, batch: int, capacity: int):
    """The decode caches of ``batch`` sequences of ``capacity`` tokens on
    the ``meta`` device."""
    return init_caches(cfg, batch, capacity, device="meta")


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


def _hooked_leaf(src: torch.Tensor, dst: torch.Tensor, done: list):
    """A detached leaf of ``src`` whose gradient, once accumulated, is
    copied into ``dst`` and dropped."""
    def hook(leaf):
        dst.copy_(leaf.grad)
        leaf.grad = None
        done.append(1)

    leaf = src.detach().requires_grad_()
    leaf.register_post_accumulate_grad_hook(hook)
    return leaf


def stacked_grad_fn(cfg: ArchConfig):
    """``grad_fn(params, batch) -> (losses (n,), grads)`` over the stacked
    client axis: client i's loss and its autograd gradient, the clients
    one after another, each client's graph freed before the next starts.
    The gradients are fresh stacked tensors.  Each layer of a layer stack
    is a leaf of its own (``models.model.layer_stacks``), and every
    leaf's gradient is copied into the stacked tensor as soon as the
    backward has it and then dropped: a layer's weight gradients do not
    wait out the rest of the backward (the values are autograd's, bit for
    bit).  Inside the 2-D engine's :func:`repro_torch.models.model.
    model_shards` scope the params are this process's blocks of a
    model-sharded tree: the model runs its products on the blocks (or
    makes each layer whole as it runs it), the leaves' gradients arrive
    already cut to the blocks, and the returned gradients are blocks
    too."""
    stacks = layer_stacks(cfg)

    def grad_fn(params, batch):
        leaves, treedef = tree_flatten(params)
        layered = tree_flatten({key: tree_map(lambda _: key in stacks, val)
                                for key, val in params.items()})[0]
        n = leaves[0].shape[0]
        grads = [torch.empty_like(a) for a in leaves]
        losses = torch.empty((n,), dtype=torch.float32,
                             device=leaves[0].device)
        for i in range(n):
            own, done = [], []
            for a, dst, per_layer in zip(leaves, grads, layered):
                own.append(tuple(_hooked_leaf(s, d, done)
                                 for s, d in zip(a[i], dst[i]))
                           if per_layer else _hooked_leaf(a[i], dst[i], done))
            with torch.enable_grad():
                loss, _ = model_loss_fn(tree_unflatten(treedef, own), cfg,
                                        _client(batch, i))
                loss.backward()
            if len(done) != len(tree_leaves(own)):
                raise RuntimeError("a parameter leaf got no gradient")
            losses[i] = loss.detach()
            del own, loss
        return losses, tree_unflatten(treedef, grads)

    return grad_fn


def stacked_loss_fn(cfg: ArchConfig):
    """``loss_fn(params, batch) -> losses (n,)``: the clients' losses
    without autograd (the aggregation branches'); on blocks within
    ``model_shards`` as :func:`stacked_grad_fn`."""

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


def _plans(cfg, client_comp, master_comp, plans):
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
    ``average_fn`` (optional, :func:`build_average_fn`) replaces the
    fresh branch's aggregation: a per-shard average over this process's
    clients, the losses then summed over its axis.

    Returns ``train_step(state, batch, xi, key) -> (state, metrics)``
    with ``xi`` this step's host draw (0 or 1) and ``key`` its
    compressor key (two uint32 words)."""
    up_plan, down_plan = _plans(cfg, client_comp, master_comp, plans)
    grad_fn, loss_fn = stacked_grad_fn(cfg), stacked_loss_fn(cfg)
    axis = _average_axis(average_fn)

    def train_step(state: L2GDState, batch, xi, key):
        return l2gd_step(state, batch, int(xi), key, grad_fn, hp, up_plan,
                         down_plan, average_fn, axis_name=axis,
                         loss_fn=loss_fn)

    return train_step


def _average_axis(average_fn):
    """The client axis an ``average_fn`` spans when it spans more than
    one process (the losses are then summed over it), else None: on one
    process the step keeps the stacked mean."""
    axis = getattr(average_fn, "axis", None)
    return axis if axis is not None and axis.size > 1 else None


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
    up_plan, down_plan = _plans(cfg, client_comp, master_comp, plans)
    grad_fn, loss_fn = stacked_grad_fn(cfg), stacked_loss_fn(cfg)
    axis = _average_axis(average_fn)

    def rollout(state: L2GDState, batches, key):
        # the state goes on without this frame keeping a reference
        box = [state]
        del state
        return rollout_l2gd(key, box.pop(), hp, batches, grad_fn=grad_fn,
                            steps=length, client_comp=up_plan,
                            master_comp=down_plan, local_steps=local_steps,
                            loss_fn=loss_fn, average_fn=average_fn,
                            axis_name=axis)

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
    up_plan, down_plan = _plans(cfg, client_comp, master_comp, plans)
    grad_fn, loss_fn = stacked_grad_fn(cfg), stacked_loss_fn(cfg)

    def rollout(state: L2GDState, agg, batches, key):
        return rollout_l2gd_async(key, state, hp, batches, grad_fn=grad_fn,
                                  fault_plan=fault_plan, steps=length,
                                  client_comp=up_plan, master_comp=down_plan,
                                  agg_state=agg, loss_fn=loss_fn)

    return rollout


def build_average_fn(*args, uplink="wire", kind: str = None, **kwargs):
    """A per-shard ``average_fn`` for :func:`build_train_step` /
    :func:`build_rollout_fn`:

    ``build_average_fn(mesh, client_axes, param_pspecs_stacked,
    master_comp, uplink=...)`` with

      uplink="wire"            — a stochastically rounded bfloat16
                                 uplink averaged over the client axes
                                 (:func:`repro_torch.core.aggregation.
                                 make_sharded_average`);
      uplink=<CompressionPlan> — the plan's wire payload on the
                                 all_gather (:func:`repro_torch.core.
                                 aggregation.make_payload_sharded_average`).

    The reference's older spelling ``build_average_fn(kind, mesh, ...)``
    with kind in {"wire", "packed"} is kept, with its DeprecationWarning
    ("packed" is a packed QSGD plan; kwargs levels, bucket)."""
    from repro_torch.core.aggregation import (make_payload_sharded_average,
                                              make_sharded_average)
    if args and isinstance(args[0], str):
        kind, args = args[0], args[1:]
    if kind is not None:
        warnings.warn(
            "build_average_fn(kind=...) is deprecated; pass uplink='wire' "
            "or uplink=<CompressionPlan> (repro_torch.core.codec."
            "make_plan(comp, params, transport='packed'))",
            DeprecationWarning, stacklevel=2)
        if kind == "wire":
            uplink = "wire"
        elif kind == "packed":
            from repro_torch.core.compressors import QSGD
            uplink = make_plan(
                QSGD(levels=kwargs.pop("levels", 127),
                     bucket=kwargs.pop("bucket", 2048)), transport="packed")
        else:
            raise ValueError(f"unknown average_fn kind {kind!r}")
    if kwargs:
        raise TypeError(f"build_average_fn got unexpected keyword "
                        f"arguments {sorted(kwargs)} (levels/bucket belong "
                        "on the uplink plan's codec)")
    mesh, client_axes, param_pspecs_stacked, master_comp = args
    if isinstance(uplink, str) and uplink == "wire":
        return make_sharded_average(mesh, client_axes, param_pspecs_stacked,
                                    master_comp)
    if isinstance(uplink, CompressionPlan):
        return make_payload_sharded_average(
            mesh, client_axes, param_pspecs_stacked, master_comp, uplink)
    raise ValueError(f"uplink must be 'wire' or a CompressionPlan, "
                     f"got {uplink!r}")


def model_dims(cfg: ArchConfig, model_shards: int) -> dict:
    """The one-model parameter tree with each leaf's cut dim on
    ``model_shards`` model shards (None where whole), a layer stack's
    without its layer axis: what the split's modules see."""
    from repro_torch.launch.sharding import param_pspecs
    return _layer_dims(cfg, _spec_dims(param_pspecs(
        param_shapes(cfg), model_shards, client_axes=())))


def split_gathers(cfg: ArchConfig, model_shards: int) -> dict:
    """The one-model tree of :func:`repro_torch.models.model.
    gathered_leaves` on ``model_shards`` model shards: True where the 2-D
    engine's split still makes a cut leaf whole inside the layer (its
    cut not on whole heads, experts or channels)."""
    return gathered_leaves(cfg, model_dims(cfg, model_shards), model_shards)


def lacks_remat(cfg: ArchConfig, model_shards: int,
                gather_layers: bool = False) -> bool:
    """Whether the 2-D engine refuses ``cfg`` on ``model_shards`` model
    shards: a layer that gathers leaves inside the layer loop (every
    layer with ``gather_layers``; under the split, a layer with a leaf of
    :func:`split_gathers`) frees the whole weights after the layer's
    forward only under remat (remat changes no bit)."""
    if model_shards <= 1 or cfg.remat:
        return False
    return gather_layers or any(tree_leaves(split_gathers(cfg,
                                                          model_shards)))


class _ModelShards:
    """The 2-D engine's view of one tree on the ``model`` axis: each leaf
    cut on the dim its spec names "model" (if any), this process's
    block of it."""

    def __init__(self, mesh, specs):
        self.axis = MeshAxis(mesh, "model")
        self.dims = _spec_dims(specs)

    def full(self, tree):
        """Every leaf whole: the model shards gathered (one process a
        shard: the leaf itself)."""
        return _zip_dims(lambda a, d: whole_of(a, self.axis, d), tree,
                         self.dims)

    def local(self, tree):
        """This process's block of each whole leaf."""
        return _zip_dims(lambda a, d: block_of(a, self.axis, d), tree,
                         self.dims)

    def layer_gather(self, cfg: ArchConfig):
        """The ``whole(key, tree)`` of :func:`repro_torch.models.model.
        model_shards` for a one-model tree of these specs: a layer
        stack's dims less its layer axis, each leaf through
        :func:`repro_torch.core.collective.gather_blocks`."""
        dims = _layer_dims(cfg, self.dims)

        def whole(key, tree):
            return _zip_dims(lambda a, d: gather_blocks(a, self.axis, d),
                             tree, dims[key])

        return whole

    def layer_split(self, cfg: ArchConfig):
        """The ``split(key)`` of :func:`repro_torch.models.model.
        model_shards` for a one-model tree of these specs: a
        :class:`repro_torch.core.collective.ModelSplit` of each top-level
        key's dims (a layer stack's less its layer axis)."""
        splits = {key: ModelSplit(self.axis, val) for key, val in
                  _layer_dims(cfg, self.dims).items()
                  if isinstance(val, dict)}
        return splits.get


def _layer_dims(cfg: ArchConfig, dims):
    """The dims of a one-model tree with a layer stack's less its layer
    axis."""
    stacks = layer_stacks(cfg)
    return {key: _zip_dims(lambda _, d: d if d is None or key not in stacks
                           else d - 1, val, val)
            for key, val in dims.items()}


def _spec_dims(specs):
    """The "model" dim of each spec of a spec tree (None: replicated)."""
    if isinstance(specs, dict):
        return {k: _spec_dims(v) for k, v in specs.items()}
    return specs.index("model") if "model" in specs else None


def _zip_dims(fn, tree, dims):
    if isinstance(tree, dict):
        return {k: _zip_dims(fn, v, dims[k]) for k, v in tree.items()}
    return fn(tree, dims)


def build_sharded_rollout_fn(cfg: ArchConfig, hp: L2GDHyper, *, mesh,
                             client_comp=Identity(), master_comp=Identity(),
                             participation: Optional[float] = None,
                             length: int = 8, axis_name: str = "clients",
                             local_steps: int = 1,
                             gather_layers: bool = False):
    """Client-sharded multi-round train function, SPMD over the processes
    of ``mesh`` (``launch.mesh``).

    On a 1-D ``clients`` mesh it is :func:`repro_torch.core.rollout.
    rollout_l2gd_sharded`: each process trains hp.n / n_processes whole
    models, and the fresh branch all_gathers their wire payloads.

    On a mesh with a ``model`` axis (``launch.mesh.make_train_mesh``) it
    is the 2-D engine.  Each process holds its client row's clients, and
    each leaf cut on "model" by ``launch.sharding.train_state_pspecs``
    (the cache too).  The reference lets GSPMD partition the stacked
    scan with the Megatron specs; the port runs the model inside
    :func:`repro_torch.models.model.model_shards` with the same split
    written out: each product runs on this process's blocks (column
    products q / k / v, gate and up; row products o and down, their
    partial sums summed over "model" in rank order, so every model shard
    of a row holds the same bits; expert-parallel MoE, d_inner-parallel
    Mamba on the scan kernels, a vocab-parallel table and loss), and the
    gradients' blocks come straight from autograd.  A leaf whose cut does
    not fall on whole heads, experts or channels
    (:func:`split_gathers`) is gathered whole inside the layer instead,
    where remat is required (a ValueError without it,
    :func:`lacks_remat`).  Every model shard of a row sees the row's full
    batch.  A process holds its blocks of the state and of the gradient
    (``launch.dryrun``'s ``engine_step_bytes_per_process``).
    ``gather_layers=True`` keeps the engine that divides only the
    memory: each layer's leaves (and the tied table, at its two points
    of use) are gathered whole only while that layer runs, inside the
    function that remat checkpoints (remat required), the gather's
    backward keeping this process's block of the layer's whole gradient,
    and every shard runs its row's whole products.  The aggregation's
    codecs see whole leaves (their buckets and
    threefry counters run over the whole leaf).  With a leafwise uplink
    it goes a leaf piece at a time, a layer stack's leaf a layer at a
    time (its counters at their offsets in the whole leaf), each piece
    made whole, compressed and cut back to the block: one client row is
    the stacked ``compressed_average``, several rows gather their
    clients' payloads over ``clients`` as :func:`repro_torch.core.
    aggregation.make_client_sharded_average` does, both given the
    engine's :class:`repro_torch.core.aggregation.ModelCut`.  A flat or
    packed uplink, or a fleet, spans the leaves and still gathers the
    row's whole models for the aggregation.  Every replicated value (target,
    losses) is computed from the same gathered tensors in the same order
    on every process.  Contract: on one client row the params, cache,
    losses and xis equal :func:`build_rollout_fn`'s bit for bit at any
    number of model shards (the (1, 1) mesh keystone included) with
    ``gather_layers``, and with the split on one model shard (the plain
    path); on several rows params, cache and xis do, the losses to their
    summation order.  The split on more than one model shard sums each
    product's blocks in another order than one process: the reference's
    contract holds, xis equal and params within rtol 1e-5 / atol 1e-6 (a
    stochastic codec may then round an element whose input moved by an
    ulp the other way).

    Plans for plain compressors are leafwise; a FleetPlan keeps its
    cohorts' transports.  Returns ``rollout(state, batches, key) ->
    (state, RolloutTrace)`` as :func:`build_rollout_fn`; ``state`` and
    ``batches`` hold all n clients (cut here) or this process's part
    (``launch.sharding.train_state_shardings`` /
    ``train_batch_shardings``); the returned state is this process's
    part, and ``rollout.full_state(state)`` gathers it whole on every
    process."""
    from repro_torch.core.aggregation import (ModelCut, compressed_average,
                                              make_client_sharded_average)
    from repro_torch.core.rollout import _cut_clients, rollout_l2gd_sharded
    from repro_torch.launch.mesh import model_shards_of
    from repro_torch.launch.sharding import param_pspecs, tree_local
    shapes = param_shapes(cfg)
    up_plan = _uplink_plan(client_comp, shapes)
    down_plan = make_plan(master_comp, shapes, transport="leafwise")
    grad_fn, loss_fn = stacked_grad_fn(cfg), stacked_loss_fn(cfg)
    n = int(hp.n)
    clients = MeshAxis(mesh, axis_name)
    if n % clients.size:
        raise ValueError(f"n={n} clients do not divide the {axis_name!r} "
                         f"mesh axis of size {clients.size}")
    m = n // clients.size

    if "model" not in (mesh.mesh_dim_names or ()):
        def rollout(state: L2GDState, batches, key):
            box = [state]
            del state
            return rollout_l2gd_sharded(
                key, box.pop(), hp, batches, mesh=mesh, grad_fn=grad_fn,
                steps=length, client_comp=up_plan, master_comp=down_plan,
                participation=participation, axis_name=axis_name,
                local_steps=local_steps, loss_fn=loss_fn)

        rollout.full_state = lambda st: st._replace(params=tree_map(
            lambda a: clients.all_gather(a).reshape((n,) + a.shape[1:]),
            st.params))
        return rollout

    msize = model_shards_of(mesh)
    if lacks_remat(cfg, msize, gather_layers):
        raise ValueError(
            f"the 2-D engine on {msize} model shards gathers leaves "
            "inside the layer loop and drops them after the layer's "
            "forward, which needs remat: with cfg.remat off autograd would "
            "keep every layer's gathered weights (set remat=True)")
    stacked = stacked_param_shapes(cfg, n)
    p_specs = param_pspecs(stacked, msize, client_axes=(axis_name,))
    c_specs = param_pspecs(shapes, msize, client_axes=())
    p_shards = _ModelShards(mesh, p_specs)
    c_shards = _ModelShards(mesh, c_specs)
    # one model shard runs the plain path
    scope = {} if msize == 1 else dict(whole=c_shards.layer_gather(cfg)) \
        if gather_layers else dict(split=c_shards.layer_split(cfg))
    leafwise = isinstance(up_plan, CompressionPlan) \
        and up_plan.transport == "leafwise"
    # leafwise plans average the blocks a leaf piece at a time; a
    # transport that spans leaves takes the clients' whole models
    stacks = layer_stacks(cfg)
    cut = ModelCut(p_shards.axis, tuple(tree_leaves(p_shards.dims)), tuple(
        tree_leaves({key: _zip_dims(lambda _, d: key in stacks, val, val)
                     for key, val in p_shards.dims.items()}))) \
        if leafwise else None
    sharded_avg = None if clients.size == 1 else \
        make_client_sharded_average(clients, n, up_plan, down_plan, cut)

    def grad2d(params, batch):
        with model_shards(**scope):
            return grad_fn(params, batch)

    def loss2d(params, batch):
        with model_shards(**scope):
            return loss_fn(params, batch)

    def average2d(key, params, mask=None):
        if leafwise and sharded_avg is None:
            return compressed_average(key, params, up_plan, down_plan,
                                      mask=mask, cut=cut)
        if leafwise:
            return sharded_avg(key, params, mask)
        full = p_shards.full(params)
        if sharded_avg is None:
            target = compressed_average(key, full, up_plan, down_plan,
                                        mask=mask)
        else:
            target = sharded_avg(key, full, mask)
        del full
        return c_shards.local(target)

    axis = None if clients.size == 1 else clients

    def _place(state, batches):
        # whole where every leaf has its global shape (a leaf the axes
        # leave whole says nothing: the table of a vocab that does not
        # divide)
        if all(tuple(a.shape) == tuple(g.shape) for a, g in zip(
                tree_leaves(state.params), tree_leaves(stacked))):
            from repro_torch.launch.sharding import train_state_pspecs
            state = tree_local(mesh, train_state_pspecs(state, msize,
                                                        axis_name), state)
        return state, _cut_clients(batches, n, m, clients.index, 1)

    def rollout(state: L2GDState, batches, key):
        state, batches = _place(state, batches)
        box = [state]
        del state
        return rollout_l2gd(key, box.pop(), hp, batches, grad_fn=grad2d,
                            steps=length, client_comp=up_plan,
                            master_comp=down_plan,
                            participation=participation,
                            local_steps=local_steps, loss_fn=loss2d,
                            average_fn=average2d, axis_name=axis)

    def full_state(st):
        params = p_shards.full(st.params)
        if clients.size > 1:
            params = tree_map(lambda a: clients.all_gather(a).reshape(
                (n,) + a.shape[1:]), params)
        return st._replace(params=params, cache=c_shards.full(st.cache))

    rollout.full_state = full_state
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
