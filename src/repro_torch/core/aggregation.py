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

The sharded half runs SPMD on ``torch.distributed``: every process calls
the same function on its own clients, and the reference's axis names
are :class:`~repro_torch.core.collective.MeshAxis` objects
(``launch.mesh.mesh_axis``):

  * :func:`make_client_sharded_average` — the client-sharded rollout's
    exchange: this process's slice of the global key schedule, its
    clients' wire payloads ``all_gather``-ed (the packed codes cross the
    wire, never dequantized float32), then the one-pass fused
    decode->reduce over all n messages;
  * :func:`make_payload_sharded_average` / :func:`make_packed_sharded_
    average` — one payload a process (its clients' local mean), gathered
    and reduced the same way;
  * :func:`make_sharded_average` / :func:`compressed_average_wire` — a
    stochastically rounded bfloat16 uplink averaged over the axis.

A codec's buckets and threefry counters run over the whole leaf, so a
leaf cut over a model axis (the 2-D engine of ``launch.steps``) is made
whole before it is compressed.  With leafwise plans both ways,
:func:`compressed_average` and :func:`make_client_sharded_average` take
that cut as a :class:`ModelCut` and go a piece at a time: a leaf of a
layer stack one layer at a time (its counters at their offsets in the
whole leaf, so the bits are the whole leaf's), any other leaf whole, and
each piece cut back to this process's block once it is compressed.  A
transport that spans leaves (flat, packed, a fleet) needs the whole
models.

The stacked average records ``repro_torch.tracing`` spans: leafwise,
``uplink`` around the compression of every leaf piece, then ``mean``
and ``downlink`` a piece at a time; flat and packed, ``encode``,
``reduce`` and ``downlink``.  Every message compressed adds its payload
bits to ``wire.up_bits`` (each client's) or ``wire.down_bits`` (the
master's): the payload tensors' where they are made, else the codec's
payload for the piece's shape.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import flatbuf, prng
from repro_torch.core.codec import (CompressionPlan, TreePayload, as_plan,
                                    make_plan)
from repro_torch.core.collective import block_of, whole_of
from repro_torch.core.compressors import QSGD
from repro_torch.core.tree import (spec_leaves, tree_flatten, tree_leaves,
                                   tree_map, tree_unflatten)

__all__ = ["compressed_average", "compressed_average_wire",
           "stochastic_round_cast", "make_sharded_average",
           "make_payload_sharded_average", "make_packed_sharded_average",
           "make_client_sharded_average", "ModelCut", "masked_client_mean",
           "stacked_finite_mask", "weighted_client_sum", "client_mean",
           "all_finite"]


#: "up_bits" / "down_bits": the payload bits of the messages compressed,
#: every client's up and the master's down
WIRE = tracing.counter("wire")


def _spec_bits(codec, shape) -> int:
    """The payload bits of one message of ``shape`` under ``codec``."""
    return int(codec.payload_spec(tuple(shape)).nbits)


def _plan_bits(plan, tree) -> int:
    """The payload bits of one message of the one-model ``tree`` under
    ``plan``."""
    leaves = tree_leaves(tree)
    if plan.transport == "leafwise":
        return sum(_spec_bits(plan.codec, a.shape) for a in leaves)
    return int(flatbuf.payload_spec(plan.codec,
                                    sum(a.numel() for a in leaves),
                                    bucket=plan.bucket,
                                    narrow=plan.narrow).nbits)


def _downlink(plan, key, ybar):
    """C_M of the mean, a ``downlink`` span, its message counted."""
    with tracing.span("downlink"):
        WIRE["down_bits"] += _plan_bits(plan, ybar)
        return plan.apply(key, ybar)


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


class ModelCut(NamedTuple):
    """How the leaves of a client-stacked tree are cut over a model axis
    (the 2-D engine's layout): ``axis`` is the MeshAxis; in tree-flatten
    order, ``dims`` gives each leaf's cut dim counting the client axis
    (None: whole on every process) and ``layered`` whether the leaf
    carries a layer stack's layers on dim 1."""

    axis: Any
    dims: tuple
    layered: tuple


def _leafwise(up_plan, down_plan) -> bool:
    return isinstance(up_plan, CompressionPlan) \
        and up_plan.transport == "leafwise" \
        and down_plan.transport == "leafwise"


def compressed_average(key, params_stacked, client_comp, master_comp, *,
                       mask=None, cut=None):
    """t = C_M((1/n) sum_j C_j(x_j)) for stacked client params.

    ``client_comp`` / ``master_comp`` are CompressionPlans or plain
    compressors (auto transport); ``client_comp`` may also be a
    :class:`repro_torch.fl.fleet.FleetPlan` (per-cohort uplinks).
    ``mask`` (optional (n,) 0/1 tensor) restricts the mean to a
    participant subset.  ``cut`` (a :class:`ModelCut`, leafwise plans
    both ways) takes each process's blocks of the params and returns its
    blocks of t, equal to the blocks of the whole call's t."""
    up_plan = _resolve_uplink(client_comp)
    down_plan = as_plan(master_comp)
    n = tree_leaves(params_stacked)[0].shape[0]
    k_clients, k_master = prng.split(key)
    client_keys = prng.split(k_clients, n)
    if cut is not None and not _leafwise(up_plan, down_plan):
        raise ValueError("a model cut takes leafwise plans both ways; a "
                         "transport that spans leaves needs whole models")
    if _leafwise(up_plan, down_plan):
        return _leafwise_average(up_plan, down_plan, client_keys, k_master,
                                 params_stacked, mask, cut)
    if not isinstance(up_plan, CompressionPlan):
        from repro_torch.fl.fleet import fleet_mean
        if up_plan.n_clients != n:
            raise ValueError(f"fleet covers {up_plan.n_clients} clients; "
                             f"params are stacked for {n}")
        ybar = fleet_mean(up_plan, client_keys, params_stacked, mask)
    elif up_plan.transport in ("flat", "packed"):
        with tracing.span("encode"):
            payload = up_plan.encode(client_keys, params_stacked)
            WIRE["up_bits"] += int(payload.nbits)
        with tracing.span("reduce"):
            ybar = flatbuf.reduce_payload_mean(payload, mask)
    else:
        # a leafwise uplink with a flat or packed downlink
        with tracing.span("uplink"):
            compressed = up_plan.apply(client_keys, params_stacked)
            WIRE["up_bits"] += n * _plan_bits(
                up_plan, tree_map(lambda a: a[0], compressed))
        with tracing.span("mean"):
            ybar = tree_map(_guarded_mean(stacked_finite_mask(compressed),
                                          mask), compressed)
        del compressed
    return _downlink(down_plan, k_master, ybar)


def _guarded_mean(fin, mask):
    """The leafwise uplink's mean over clients of one compressed leaf (or
    a piece of it), as a function: clients whose ``fin`` flag is 0 (a
    non-finite value in some leaf) leave it; the plain (masked) mean is
    selected when all are finite, so that path stays the reference's."""
    all_ok = all_finite(fin)
    w = fin if mask is None else mask.reshape(-1).to(torch.float32) * fin
    denom = torch.sum(w)
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))

    def mean(a):
        guarded = weighted_client_sum(a, w) / safe.to(a.dtype)
        return torch.where(all_ok, masked_client_mean(a, mask), guarded)

    return mean


def _pieces(leaf, dim, layered, size, codecs):
    """The pieces a client-stacked leaf (this process's block, cut on
    ``dim`` over ``size`` processes) is compressed in: (its layer on dim
    1 or None for the whole leaf, the piece's first counter in a client's
    whole leaf).  A layer stack's leaf goes a layer at a time where every
    codec takes the offsets."""
    layers = leaf.shape[1] if leaf.dim() > 1 else 1
    if not layered or dim == 1 or layers == 1:
        return [(None, 0)]
    per = math.prod(leaf.shape[2:]) * (1 if dim is None else size)
    if any(not c.slice_unit() or per % c.slice_unit() for c in codecs):
        return [(None, 0)]
    return [(i, i * per) for i in range(layers)]


def _leafwise_average(up_plan, down_plan, client_keys, k_master, params,
                      mask, cut, clients=None, n_clients=None):
    """The average with leafwise plans both ways, a leaf piece at a time
    (:func:`_pieces`), on this process's blocks when ``cut`` is given:
    each piece is made whole, compressed with its leaf's key at its
    offset, and cut back to the block.  One client row (``clients``
    None): the clients' compressed blocks and their finite flags (ANDed
    over the leaves), then for each piece the guarded mean of the blocks
    (elementwise over clients, so the block of the mean) and C_M.
    Several rows (``clients`` the MeshAxis of the rows, ``n_clients`` in
    all): each piece's payload gathered over ``clients`` and decoded a
    client at a time, its masked mean and C_M, with no flags.  The keys
    are the whole-tree call's: leaf j of client i uses ``split(
    client_keys[i], n_leaves)[j]``, of C_M ``split(k_master,
    n_leaves)[j]``."""
    leaves, treedef = tree_flatten(params)
    if cut is None:
        cut = ModelCut(None, (None,) * len(leaves), (False,) * len(leaves))
    axis, count = cut.axis, max(len(leaves), 1)
    size = 1 if axis is None else axis.size
    m, device = leaves[0].shape[0], leaves[0].device
    leaf_keys = prng.split(client_keys, count)
    down_keys = prng.split(k_master, count)
    up, down = up_plan.codec, down_plan.codec
    pieces = [_pieces(a, d, lay, size, (up, down))
              for a, d, lay in zip(leaves, cut.dims, cut.layered)]

    def part(a, i):
        return a if i is None else a.narrow(1, i, 1)

    def into(dst, i, x):
        if i is None:
            return x
        part(dst, i).copy_(x)
        return dst

    def downlink(j, i, offset, ybar_piece, out):
        d = cut.dims[j]
        d = None if d is None else d - 1
        with tracing.span("downlink"):
            whole = whole_of(ybar_piece, axis, d)
            WIRE["down_bits"] += _spec_bits(down, whole.shape)
            y = down.apply(down_keys[j], whole, offset)
            # a piece of a mean leaf: the layer axis is its dim 0
            if i is None:
                return block_of(y, axis, d)
            out.narrow(0, i, 1).copy_(block_of(y, axis, d))
            return out

    def uplink(j, i, offset, compress):
        whole = whole_of(part(leaves[j], i), axis, cut.dims[j])
        WIRE["up_bits"] += m * _spec_bits(up, whole.shape[1:])
        return compress(leaf_keys[:, j], whole, offset)

    outs = [None] * len(leaves)
    if clients is None:
        fin = torch.ones((m,), dtype=torch.bool, device=device)
        compressed = []
        with tracing.span("uplink"):
            for j, a in enumerate(leaves):
                c = None if pieces[j][0][0] is None else torch.empty_like(a)
                for i, offset in pieces[j]:
                    y = uplink(j, i, offset, up.apply)
                    fin &= torch.isfinite(y.to(torch.float32)) \
                        .reshape(m, math.prod(y.shape[1:])).all(dim=1)
                    c = into(c, i, block_of(y, axis, cut.dims[j]))
                    del y
                compressed.append(c)
        mean = _guarded_mean(fin.to(torch.float32), mask)
        for j, c in enumerate(compressed):
            out = None if pieces[j][0][0] is None else \
                torch.empty_like(c[0])
            for i, offset in pieces[j]:
                with tracing.span("mean"):
                    ybar = mean(part(c, i))
                out = downlink(j, i, offset, ybar, out)
                del ybar
            compressed[j] = None
            outs[j] = out
        return tree_unflatten(treedef, outs)
    for j, a in enumerate(leaves):
        out = None if pieces[j][0][0] is None else torch.empty_like(a[0])
        for i, offset in pieces[j]:
            with tracing.span("uplink"):
                payload = uplink(j, i, offset, up.encode)
                gathered = _gather_payloads(payload, clients, batched=True)
                del payload
                blocks = None
                for k in range(n_clients):
                    one = block_of(up.decode(_wire_map(
                        lambda t: t[k:k + 1], gathered)), axis, cut.dims[j])
                    if blocks is None:
                        blocks = one.new_empty((n_clients,) + one.shape[1:])
                    blocks[k:k + 1].copy_(one)
                del gathered
            with tracing.span("mean"):
                ybar = masked_client_mean(blocks, mask)
            out = downlink(j, i, offset, ybar, out)
            del ybar
        outs[j] = out
    return tree_unflatten(treedef, outs)


# ---------------------------------------------------------------------------
# the sharded half: one process a shard, torch.distributed collectives
# ---------------------------------------------------------------------------

def stochastic_round_cast(key, x: torch.Tensor,
                          dtype=torch.bfloat16) -> torch.Tensor:
    """Unbiased stochastic rounding of float32 ``x`` to bfloat16, bit for
    bit the reference's: bf16 is the top 16 bits of f32, so the low 16
    bits are dropped and the kept magnitude bumped up one bf16 step with
    probability low16 / 2^16, against ``uniform(key, x.shape)`` drawn
    from the same threefry stream as ``jax.random.uniform``.  Non-finite
    values pass through.  The carry is an integer add, so a bump from the
    largest finite bf16 gives Inf, as the reference's does."""
    if dtype != torch.bfloat16:
        raise NotImplementedError("stochastic_round_cast targets bf16")
    xf = x.to(torch.float32)
    bits = xf.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    prob = (bits & 0xFFFF).to(torch.float32) * (1.0 / 65536.0)
    u = prng.tensor_uniform(key, tuple(x.shape), x.device)
    up = (u < prob).to(torch.int64)
    trunc = ((bits & 0xFFFF0000) + (up << 16)) & 0xFFFFFFFF
    out = torch.where(trunc >= 2 ** 31, trunc - 2 ** 32, trunc) \
        .to(torch.int32).view(torch.float32)
    return torch.where(torch.isfinite(xf), out, xf).to(dtype)


def _wire_map(fn, payload):
    """``fn`` on every tensor of a wire payload (a payload dataclass, a
    :class:`TreePayload` of them, or a plain tree of tensors); the static
    fields (layout, levels, shape, dtype) are kept."""
    if isinstance(payload, TreePayload):
        return dataclasses.replace(payload, leaves=tuple(
            _wire_map(fn, p) for p in payload.leaves))
    if dataclasses.is_dataclass(payload):
        return dataclasses.replace(payload, **{
            f.name: fn(getattr(payload, f.name))
            for f in dataclasses.fields(payload)
            if isinstance(getattr(payload, f.name), torch.Tensor)})
    return tree_map(fn, payload)


def _gather_payloads(payload, axis, *, batched: bool):
    """``all_gather`` every wire tensor of a payload over ``axis`` (a
    MeshAxis) — the packed arrays cross the wire, never dequantized
    float32 — and fold the gathered axes (plus the local client axis
    when ``batched``) into one leading axis in global client order."""
    def one(a):
        g = axis.all_gather(a)
        tail = tuple(a.shape[1:]) if batched else tuple(a.shape)
        return g.reshape((-1,) + tail)

    return _wire_map(one, payload)


def _gather_reduce(plan, payload, axis, *, batched: bool, mask=None):
    """Gather the payloads, then the masked mean through the one-pass
    fused decode->reduce for flat-engine payloads; leafwise payload trees
    decode every message and take the masked mean."""
    gathered = _gather_payloads(payload, axis, batched=batched)
    if flatbuf.supports_fused_reduce(gathered):
        return flatbuf.reduce_payload_mean(gathered, mask)
    deq = plan.decode(gathered)
    if mask is None and not batched:
        return tree_map(lambda a: client_mean(a.to(torch.float32)), deq)
    return masked_client_mean(deq, mask)


def _local_keys(k_clients, n_clients: int, m: int, axis):
    """This process's m rows of the global schedule ``split(k_clients,
    n)``: rows axis.index * m onward."""
    lo = axis.index * m
    return prng.split(k_clients, n_clients)[lo:lo + m]


def make_client_sharded_average(axis, n_clients: int, client_comp,
                                master_comp, cut=None):
    """``average_fn(key, params_local, mask=None)`` of the client-sharded
    rollout: each process holds m = n / axis.size clients (its slice of
    the leading client axis) and

    1. takes its rows of the global key schedule ``split(k_clients, n)``;
    2. encodes each of its clients to the wire payload;
    3. ``all_gather``s the payloads over ``axis`` (the codes cross);
    4. folds all n messages into the (masked) mean in one pass — leafwise
       payload trees decode and take the masked mean;

    then applies the downlink C_M with the shared ``k_master``, the same
    on every process.  ``mask`` is the GLOBAL (n,) participation mask.
    On one process at full participation this is the stacked
    :func:`compressed_average` bit for bit (flat / packed uplinks).

    A mixed :class:`~repro_torch.fl.fleet.FleetPlan` (or a length-n plan
    vector) encodes every local client under each used cohort's plan,
    gathers each cohort's batch, and weights client i by the static 0/1
    cohort membership x the mask x the finite guard before that cohort's
    fused fold; the cohort sums add in cohort order and divide once by
    the participant weight, as the reference's.

    With leafwise plans both ways the exchange goes a leaf piece at a
    time (a layer stack's leaf a layer at a time), each piece's payload
    gathered, decoded and averaged before the next: the same bits, with
    one piece of the n clients' payloads at hand at once.  ``cut`` (a
    :class:`ModelCut`, leafwise plans only) then takes and returns this
    process's blocks of a tree cut over a model axis."""
    if isinstance(client_comp, (list, tuple)):
        from repro_torch.fl.fleet import fleet_from_plans
        client_comp = fleet_from_plans(client_comp)
    up = _resolve_uplink(client_comp)
    down_plan = as_plan(master_comp)
    if cut is not None and not _leafwise(up, down_plan):
        raise ValueError("a model cut takes leafwise plans both ways; a "
                         "transport that spans leaves needs whole models")

    if _leafwise(up, down_plan):

        def average_fn(key, params_local, mask=None):
            m = tree_leaves(params_local)[0].shape[0]
            k_clients, k_master = prng.split(key)
            return _leafwise_average(
                up, down_plan, _local_keys(k_clients, n_clients, m, axis),
                k_master, params_local, mask, cut, axis, n_clients)

        average_fn.axis = axis
        return average_fn

    if isinstance(up, CompressionPlan):
        up_plan = up

        def average_fn(key, params_local, mask=None):
            m = tree_leaves(params_local)[0].shape[0]
            k_clients, k_master = prng.split(key)
            local_keys = _local_keys(k_clients, n_clients, m, axis)
            with tracing.span("encode"):
                payload = up_plan.encode(local_keys, params_local)
                WIRE["up_bits"] += int(payload.nbits)
            with tracing.span("reduce"):
                ybar = _gather_reduce(up_plan, payload, axis, batched=True,
                                      mask=mask)
            del payload
            return _downlink(down_plan, k_master, ybar)

        average_fn.axis = axis
        return average_fn

    fleet = up
    if fleet.n_clients != n_clients:
        raise ValueError(f"fleet covers {fleet.n_clients} clients; the "
                         f"sharded engine runs {n_clients}")

    def average_fn(key, params_local, mask=None):
        leaves = tree_leaves(params_local)
        m, device = leaves[0].shape[0], leaves[0].device
        k_clients, k_master = prng.split(key)
        local_keys = _local_keys(k_clients, n_clients, m, axis)
        base = torch.ones((n_clients,), dtype=torch.float32, device=device) \
            if mask is None else mask.reshape(-1).to(torch.float32)
        total = None
        wsum = torch.zeros((n_clients,), dtype=torch.float32, device=device)
        for c in fleet.used_cohorts:
            plan_c = fleet.cohorts[c]
            member = torch.tensor(
                [1.0 if a == c else 0.0 for a in fleet.assignment],
                dtype=torch.float32, device=device)
            if plan_c.transport in ("flat", "packed"):
                gathered = _gather_payloads(
                    plan_c.encode(local_keys, params_local), axis,
                    batched=True)
                fin = flatbuf.payload_finite_mask(gathered)
                gathered = flatbuf.sanitize_payload(gathered, fin)
                w = member * base * fin
                acc = flatbuf.reduce_payload_acc(gathered, w)
                part = flatbuf.unravel(
                    gathered.layout,
                    flatbuf.unbucketize(acc, gathered.layout.d))
            else:
                gathered = _gather_payloads(
                    plan_c.apply(local_keys, params_local), axis,
                    batched=True)
                fin = stacked_finite_mask(gathered)
                w = member * base * fin
                part = weighted_client_sum(gathered, w)
            del gathered
            part = tree_map(lambda a: a.to(torch.float32), part)
            total = part if total is None else tree_map(torch.add, total,
                                                        part)
            wsum = wsum + w
        denom = torch.sum(wsum)
        safe = torch.where(denom > 0, denom, torch.ones_like(denom))
        ybar = tree_map(lambda s_, a: (s_ / safe).to(a.dtype), total,
                        params_local)
        return down_plan.apply(k_master, ybar)

    average_fn.axis = axis
    return average_fn


def _check_leading_client_specs(param_pspecs_stacked, client_axes):
    """The per-shard averages take whole leaves: a spec may name the
    client axes on the leading dim only."""
    lead = client_axes if len(client_axes) > 1 else client_axes[0]
    for spec in spec_leaves(param_pspecs_stacked):
        spec = tuple(spec)
        if spec[:1] != (lead,) or any(e is not None for e in spec[1:]):
            raise ValueError(
                f"spec {spec}: the port's shard averages take whole leaves "
                f"(the leading dim on {lead!r}, the rest replicated); "
                "gather model-sharded dims first")


def _make_shard_map_average(mesh, client_axes: tuple, param_pspecs_stacked,
                            master_comp, uplink):
    """The per-shard averages' common part.  Per process: split the key,
    fold this process's coordinate on each client axis into the uplink
    key (independent C_i; the master key stays shared), average the local
    clients in float32, run ``uplink(k_up, local_mean) -> ybar`` (whose
    collective is the wire), cast back to the param dtypes, then apply
    the shared-key C_M downlink."""
    from repro_torch.core.collective import MeshAxis
    axes = tuple(client_axes)
    _check_leading_client_specs(param_pspecs_stacked, axes)
    axis = MeshAxis(mesh, axes)
    down_plan = as_plan(master_comp)

    def average_fn(key, params_local):
        k_up, k_master = prng.split(key)
        for name in axes:
            k_up = prng.fold_in(k_up, axis.dim_index(name))
        local_mean = tree_map(lambda a: client_mean(a.to(torch.float32)),
                              params_local)
        ybar = uplink(k_up, local_mean, axis)
        ybar = tree_map(lambda y, a: y.to(a.dtype), ybar, params_local)
        return down_plan.apply(k_master, ybar)

    average_fn.axis = axis
    return average_fn


def _bf16_mean(axis, m: torch.Tensor) -> torch.Tensor:
    """``pmean`` of a bfloat16 tensor over each dim of ``axis`` in turn:
    the gathered parts added in rank order, each sum rounded to bfloat16
    (XLA adds bf16 in float32 and rounds), then divided by the dim's size
    in bfloat16."""
    from repro_torch.core.collective import MeshAxis
    for name in axis.names:
        parts = MeshAxis(axis.mesh, name).all_gather(m)
        acc = parts[0]
        for i in range(1, parts.shape[0]):
            acc = (acc.to(torch.float32) + parts[i].to(torch.float32)) \
                .to(torch.bfloat16)
        m = (acc.to(torch.float32) / float(parts.shape[0])) \
            .to(torch.bfloat16)
    return m


def make_sharded_average(mesh, client_axes: tuple, param_pspecs_stacked,
                         master_comp):
    """An ``average_fn(key, params_local)`` whose uplink is a bfloat16
    collective: each process's local client mean, leaf by leaf, is
    stochastically rounded to bf16 (leaf j with ``split(k_up,
    n_leaves)[j]``) and averaged over the client axes on the bf16 wire;
    the downlink C_M runs with the shared key on every process."""

    def uplink(k_up, local_mean, axis):
        leaves, treedef = tree_flatten(local_mean)
        up_keys = prng.split(k_up, len(leaves))
        return tree_unflatten(treedef, [
            _bf16_mean(axis, stochastic_round_cast(k, leaf))
            for k, leaf in zip(up_keys, leaves)])

    return _make_shard_map_average(mesh, client_axes, param_pspecs_stacked,
                                   master_comp, uplink)


def make_payload_sharded_average(mesh, client_axes: tuple,
                                 param_pspecs_stacked, master_comp,
                                 uplink_plan: CompressionPlan):
    """An ``average_fn(key, params_local)`` whose uplink collective moves
    the plan's wire payload: each process encodes its local client mean,
    ``all_gather``s the payload over the client axes, and folds the
    gathered messages into the mean with the one-pass fused
    decode->reduce (leafwise payloads: decode, then the mean).  The
    downlink C_M runs with the shared key on every process."""

    def uplink(k_up, local_mean, axis):
        payload = uplink_plan.encode(k_up, local_mean)
        return _gather_reduce(uplink_plan, payload, axis, batched=False)

    return _make_shard_map_average(mesh, client_axes, param_pspecs_stacked,
                                   master_comp, uplink)


def make_packed_sharded_average(mesh, client_axes: tuple,
                                param_pspecs_stacked, master_comp, *,
                                levels: int = 127, bucket: int = 2048):
    """:func:`make_payload_sharded_average` with a packed QSGD plan
    (int8 codes, ~8.25 bits an element at bucket 2048)."""
    plan = make_plan(QSGD(levels=levels, bucket=bucket), transport="packed")
    return make_payload_sharded_average(mesh, client_axes,
                                        param_pspecs_stacked, master_comp,
                                        plan)


def compressed_average_wire(key, params_local, master_comp, axis, *,
                            wire_dtype=torch.bfloat16):
    """Compressed aggregation of one client a process: ``params_local``
    is THIS process's (unstacked) tree, the client axis is ``axis`` (a
    MeshAxis).  Uplink: stochastic rounding to ``wire_dtype``, then the
    mean over the axis on the bf16 wire; downlink: C_M with the key,
    which must be the same on every process."""
    k_up, k_master = prng.split(key)
    leaves, treedef = tree_flatten(params_local)
    up_keys = prng.split(k_up, len(leaves))
    meaned = [_bf16_mean(axis, stochastic_round_cast(
        k, leaf.to(torch.float32), wire_dtype)).to(torch.float32)
        for k, leaf in zip(up_keys, leaves)]
    return as_plan(master_comp).apply(k_master,
                                      tree_unflatten(treedef, meaned))
