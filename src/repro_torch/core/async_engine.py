"""Arrival-ordered aggregation engine with deterministic fault injection —
the counterpart of ``repro.core.async_engine`` (DESIGN.md §11).

Every other engine steps all n clients in lockstep: a communication
round completes with every payload present.  This one simulates a fleet
with stragglers, dropped uplinks and clients that go dark, every fault
drawn from the fourth threefry stream of the determinism contract
(:func:`repro_torch.fl.faults.fault_draws`): a faulty run is a pure
function of ``(key, FaultPlan)`` and replays bit for bit.

Round model.  A communication round r opens on every fresh-communication
step (protocol branch 1).  Each alive participant sends its compressed
payload with a drawn integer latency; arrival order is ``(latency,
client index)``.  The server completes the round once the first ``q =
FaultPlan.quorum_count(s)`` arrivals have reported:

  * the quorum cohort folds now, weight ``staleness_decay ** 0 = 1``;
  * stragglers land at round ``r + max(latency, 1)`` with weight
    ``staleness_decay ** delay``, held in a ring buffer of ``max_delay +
    1`` slots (slot = landing round mod slots) as ALREADY-WEIGHTED O(d)
    sums — the buffer never stores per-client payloads; the flat and
    packed uplinks fold them with the one-pass reduce kernel
    (:func:`repro_torch.core.flatbuf.reduce_payload_acc`) at those
    weights;
  * payloads that would land more than ``max_delay`` rounds late are
    evicted (counted, never folded); dropped uplinks are lost in
    transit; crashed clients neither send nor receive (their
    aggregation update is masked out).

The round's target is the staleness-weighted mean of everything that
landed, renormalized by the realized weight total (a round where nothing
lands keeps the cached target).  Non-finite payloads are excluded
mask-and-count, as in :func:`repro_torch.core.flatbuf.reduce_payload_mean`.

What the port keeps on the host: the fault draws, the participation
masks, the arrival order and every count that does not depend on the
payloads (sent, dropped, evicted, crashed) are numpy, drawn per window
with the xi stream; what depends on the payloads (the finite guard, the
weights, the buffer and its totals, the delivered / fresh / stale /
rejected counts) stays on the device, and the (K, 8) event table is
fetched once per window.  The round counter ``rnd`` is a host int: a
round opens exactly on a branch-1 step.

Keystone (tests/test_torch_async.py, ``chip_smoke.py``): with
``FaultPlan.is_null`` the engine equals :func:`repro_torch.core.rollout.
rollout_l2gd` in value — the weights are exact 0/1, the buffer folds
exact zeros (``-0.0 + 0.0`` is ``+0.0``, hence "in value"), the mean is
``reduce_payload_mean``'s ``acc / where(denom > 0, denom, 1)``, and the
key schedule is the synchronous engine's.

The async state is updated in place (the reference donates it): a
caller threads the returned one into the next window.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import flatbuf, prng
from repro_torch.core.aggregation import (all_finite, masked_client_mean,
                                          stacked_finite_mask,
                                          weighted_client_sum)
from repro_torch.core.codec import CompressionPlan, as_plan
from repro_torch.core.compressors import Identity
from repro_torch.core.l2gd import (L2GDHyper, L2GDState, aggregation_loss,
                                   aggregation_update, l2gd_step)
from repro_torch.core.rollout import (_rollout_length, participant_count,
                                      window_masks, window_streams)
from repro_torch.core.tree import tree_leaves, tree_map

__all__ = ["AsyncAggState", "AsyncRolloutTrace", "EVENT_FIELDS",
           "init_async_state", "async_l2gd_step", "rollout_l2gd_async",
           "fault_totals", "agg_state_to_tree", "agg_state_from_tree"]

#: columns of ``AsyncRolloutTrace.events`` (K, 8) int32, per step:
#:   sent      — alive participants that transmitted this round
#:   delivered — sent payloads the server eventually folds (fresh or
#:               buffered; excludes dropped / evicted / rejected)
#:   dropped   — sent payloads lost in transit
#:   evicted   — sent payloads landing > max_delay rounds late
#:   crashed   — participants offline this round (never sent)
#:   fresh     — payloads folded THIS round at staleness 0 (quorum cohort)
#:   stale     — buffered straggler payloads folded THIS round
#:   rejected  — deliverable payloads excluded by the finite guard
#: Conservation: sent == delivered + dropped + evicted + rejected.
EVENT_FIELDS = ("sent", "delivered", "dropped", "evicted", "crashed",
                "fresh", "stale", "rejected")


class AsyncAggState(NamedTuple):
    """The server's carry across communication rounds: ``buf`` holds
    already-weighted contribution sums per future landing round — one
    (n_slots, n_buckets, bucket) float32 tensor for the flat and packed
    uplinks, a tree of (n_slots, ...) leaves for leafwise — so its memory
    is O(slots * d), independent of n.  Slot ``r mod n_slots`` matures
    when round r completes."""

    buf: Any                # (n_slots, ...) weighted pending contributions
    buf_w: torch.Tensor     # (n_slots,) f32 — pending staleness-weight total
    buf_cnt: torch.Tensor   # (n_slots,) int32 — pending payload count
    rnd: int                # communication round counter


class AsyncRolloutTrace(NamedTuple):
    """:class:`repro_torch.core.rollout.RolloutTrace` plus the fault
    record."""

    losses: torch.Tensor    # (K,) f32 mean client loss, pre-update params
    xis: np.ndarray         # (K,) int32 xi_k realization
    branches: np.ndarray    # (K,) int32 protocol branch (0/1/2)
    n_local: int
    n_agg_comm: int
    n_agg_cached: int
    events: torch.Tensor    # (K, 8) int32 — EVENT_FIELDS columns


def fault_totals(trace: AsyncRolloutTrace) -> dict:
    """Host-side {event: total count} of a trace (the driver's
    ``L2GDRun.fault_stats``)."""
    ev = torch.as_tensor(trace.events).cpu().numpy()
    return {name: int(ev[:, i].sum()) for i, name in enumerate(EVENT_FIELDS)}


def agg_state_to_tree(agg: AsyncAggState) -> dict:
    """:class:`AsyncAggState` as a plain dict tree (the checkpoint form);
    ``rnd`` is the round clock the slots are indexed modulo."""
    return {"buf": agg.buf, "buf_w": agg.buf_w, "buf_cnt": agg.buf_cnt,
            "rnd": agg.rnd}


def agg_state_from_tree(tree: dict) -> AsyncAggState:
    buf_w = torch.as_tensor(tree["buf_w"]).to(torch.float32)
    return AsyncAggState(buf=tree["buf"], buf_w=buf_w,
                         buf_cnt=torch.as_tensor(tree["buf_cnt"])
                         .to(device=buf_w.device, dtype=torch.int32),
                         rnd=int(tree["rnd"]))


def _resolve_uplink(client_comp) -> CompressionPlan:
    """Single plans pass through, plain compressors coerce with auto
    transport; fleet uplinks (the reference's ``fleet_encode`` branch)
    raise."""
    if isinstance(client_comp, (list, tuple)) \
            or hasattr(client_comp, "cohorts"):
        raise NotImplementedError(
            "fleet uplinks (fleet_encode) are not ported yet: they come "
            "with fleets and the controller (ROADMAP.md Queue 1 item 4)")
    return as_plan(client_comp)


def _is_fused(plan) -> bool:
    return plan.transport in ("flat", "packed")


def init_async_state(params_stacked, client_comp,
                     fault_plan: "FaultPlan") -> AsyncAggState:
    """Empty delay buffer and round clock for a fresh async rollout, on
    the params' device.  The buffer has the uplink's accumulator geometry:
    the (n_buckets, bucket) grid of the flat-engine payload (narrow QSGD
    codes widen before folding, so their grid too) for flat and packed
    uplinks, one model's leaves (the params' dtypes) for leafwise."""
    up_plan = _resolve_uplink(client_comp)
    ns = fault_plan.n_slots
    leaves = tree_leaves(params_stacked)
    device = leaves[0].device
    if _is_fused(up_plan):
        d = flatbuf.layout_of(params_stacked, 1, batch_dims=1).d
        spec = flatbuf.payload_spec(up_plan.codec, d, bucket=up_plan.bucket)
        wire = spec.exps if hasattr(spec, "exps") else spec.codes
        buf = torch.zeros((ns,) + tuple(wire.shape), dtype=torch.float32,
                          device=device)
    else:
        buf = tree_map(lambda a: torch.zeros((ns,) + tuple(a.shape[1:]),
                                             dtype=a.dtype, device=device),
                       params_stacked)
    return AsyncAggState(buf=buf,
                         buf_w=torch.zeros((ns,), dtype=torch.float32,
                                           device=device),
                         buf_cnt=torch.zeros((ns,), dtype=torch.int32,
                                             device=device),
                         rnd=0)


def _isum(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x).to(torch.int32)


def arrival_schedule(part, lat, drp, crs, q: int, fault_plan: "FaultPlan"):
    """A fresh round's payload-free schedule, on the host, from its (n,)
    participation mask and fault draws: ``(alive, w_fresh, late, eff,
    evict)``, float32 0/1 indicators of the senders, of the quorum cohort
    that landed, of the stragglers that land within ``max_delay`` rounds
    and of the evicted, and ``eff`` the rounds each straggler misses."""
    n = part.shape[0]
    one = np.float32(1.0)
    alive = part * (one - crs)
    # arrival order = (latency, client index); non-senders rank last
    sortkey = np.where(alive > 0, lat, fault_plan.max_latency + 1) \
        .astype(np.int64) * (n + 1) + np.arange(n)
    rank = np.argsort(np.argsort(sortkey))
    in_quorum = (rank < q).astype(np.float32)
    w_fresh = alive * in_quorum * (one - drp)     # quorum cohort, landed
    strag = alive * (one - in_quorum) * (one - drp)
    eff = np.maximum(lat, 1)                      # stragglers miss round r
    evict = strag * (eff > fault_plan.max_delay).astype(np.float32)
    late = strag - evict                          # will land within D rounds
    return alive, w_fresh, late, eff, evict


def _async_agg_fresh(st: L2GDState, agg: AsyncAggState, key, part, lat, drp,
                     crs, *, n, q, hp, up_plan, down_plan,
                     fault_plan: "FaultPlan", batch, grad_fn, loss_fn,
                     participation_mask):
    """The fresh-communication branch: one arrival-ordered round.
    ``part``/``lat``/``drp``/``crs`` are this step's host arrays (n,).
    Returns (new_state, new_agg, loss, (8,) int32 event counts)."""
    D = fault_plan.max_delay
    ns = fault_plan.n_slots
    decay = fault_plan.staleness_decay
    device = tree_leaves(st.params)[0].device
    # the pre-update loss first, so that its graph is freed before the
    # round allocates
    loss = aggregation_loss(st.params, batch, grad_fn, loss_fn)
    k_clients, k_master = prng.split(key)
    client_keys = prng.split(k_clients, n)

    # ---- arrival order and the payload-free counts, on the host ----
    one = np.float32(1.0)
    alive, w_fresh, late, eff, evict = arrival_schedule(
        part, lat, drp, crs, q, fault_plan)
    to_dev = lambda a: torch.from_numpy(
        np.ascontiguousarray(a, np.float32)).to(device)

    sr = agg.rnd % ns
    stale_cnt = agg.buf_cnt[sr]
    stale_w = agg.buf_w[sr]

    # ---- encode all n clients (the synchronous key schedule), guard ----
    if _is_fused(up_plan):
        payload = up_plan.encode(client_keys, st.params)
        fin = flatbuf.payload_finite_mask(payload)
        payload = flatbuf.sanitize_payload(payload, fin)
    else:
        contrib = up_plan.apply(client_keys, st.params)
        fin = stacked_finite_mask(contrib)
    wf = to_dev(w_fresh)
    lt = to_dev(late)
    rejected = _isum((wf + lt) * (1.0 - fin))
    wf = wf * fin

    # ---- fold the quorum cohort + this round's matured slot ----
    tw = torch.sum(wf) + stale_w
    tw_safe = torch.where(tw > 0, tw, torch.ones_like(tw))
    if _is_fused(up_plan):
        layout = payload.layout
        total = flatbuf.reduce_payload_acc(payload, wf)
        total.add_(agg.buf[sr])
        ybar = flatbuf.unravel(layout,
                               flatbuf.unbucketize(total.div_(tw_safe),
                                                   layout.d))
        del total
    else:
        guarded = tree_map(lambda s, b: (s + b[sr]) / tw_safe.to(s.dtype),
                           weighted_client_sum(contrib, wf), agg.buf)
        # a round indistinguishable from a synchronous one (every
        # participant fresh and delivered, nothing stale, nothing
        # rejected) takes the synchronous mean's expression
        sync_like = all_finite(fin) & (stale_w == 0) & (stale_cnt == 0) \
            & torch.all(wf == to_dev(part))
        plain = masked_client_mean(contrib, participation_mask)
        ybar = tree_map(lambda p, g: torch.where(sync_like, p, g), plain,
                        guarded)
        del guarded, plain
    tgt = down_plan.apply(k_master, ybar)
    del ybar
    if fault_plan.is_null:
        target = tgt   # no fault can empty a round
    else:
        # empty round (nothing landed): keep aggregating vs the cache
        has = tw > 0
        target = tree_map(lambda t, c: torch.where(has, t, c.to(t.dtype)),
                          tgt, st.cache)
    del tgt

    # ---- consume slot r, schedule the stragglers into future slots ----
    buf = agg.buf
    if _is_fused(up_plan):
        buf[sr].zero_()
    else:
        tree_map(lambda b: b[sr].zero_(), buf)
    buf_w = agg.buf_w.clone()
    buf_cnt = agg.buf_cnt.clone()
    buf_w[sr] = 0.0
    buf_cnt[sr] = 0
    delivered_late = torch.zeros((), dtype=torch.int32, device=device)
    for a in range(1, D + 1):                     # a <= D
        lands = late * (eff == a)
        if not lands.any():
            continue      # the reduce would fold exact zeros into +0.0
        w_a = to_dev(lands) * fin
        wt_a = w_a * float(np.float32(decay ** a))   # staleness at fold
        slot = (agg.rnd + a) % ns                 # never == sr for a in 1..D
        if _is_fused(up_plan):
            buf[slot].add_(flatbuf.reduce_payload_acc(payload, wt_a))
        else:
            tree_map(lambda b, s: b[slot].add_(s.to(b.dtype)), buf,
                     weighted_client_sum(contrib, wt_a))
        buf_w[slot] += torch.sum(wt_a)
        buf_cnt[slot] += _isum(w_a)
        delivered_late = delivered_late + _isum(w_a)
    if _is_fused(up_plan):
        del payload
    else:
        del contrib

    # crashed clients miss the broadcast: their update is masked out
    new_params = aggregation_update(st.params, target, hp,
                                    mask=to_dev(part * (one - crs)))
    new_state = L2GDState(new_params, target, 1, st.step + 1)
    new_agg = AsyncAggState(buf, buf_w, buf_cnt, agg.rnd + 1)

    fresh_ct = _isum(wf)
    events = torch.zeros((len(EVENT_FIELDS),), dtype=torch.int32,
                         device=device)
    events[0] = int(alive.sum())                  # sent
    events[1] = fresh_ct + delivered_late         # delivered
    events[2] = int((alive * drp).sum())          # dropped
    events[3] = int(evict.sum())                  # evicted
    events[4] = int((part * crs).sum())           # crashed
    events[5] = fresh_ct                          # fresh
    events[6] = stale_cnt                         # stale
    events[7] = rejected                          # rejected
    return new_state, new_agg, loss, events


def async_l2gd_step(state: L2GDState, agg: AsyncAggState, batch, xi_k: int,
                    key, lat, drp, crs, *, grad_fn: Callable,
                    hp: L2GDHyper, up_plan, down_plan,
                    fault_plan: "FaultPlan", q: int, participation_mask=None,
                    loss_fn: Optional[Callable] = None):
    """One protocol step of Algorithm 1 under the fault model: the
    three branches of :func:`repro_torch.core.l2gd.l2gd_step`, the
    fresh-communication one replaced by the arrival-ordered round.  Local
    and cached-target steps involve no communication, so no fault fires
    there and they are the synchronous step's own.  ``lat``/``drp``/
    ``crs`` are this step's fault draws and ``participation_mask`` its
    (n,) 0/1 numpy mask (or None), consumed only on a fresh round.

    Returns ``(new_state, new_agg, {"loss", "branch", "events"})`` with
    ``events`` an (8,) int32 device tensor, or None off a fresh round."""
    n = int(hp.n)
    device = tree_leaves(state.params)[0].device
    mask_t = None if participation_mask is None else \
        torch.from_numpy(np.asarray(participation_mask, np.float32)) \
        .to(device)
    branch = 0 if int(xi_k) == 0 else (1 if state.xi_prev == 0 else 2)
    if branch != 1:
        new_state, metrics = l2gd_step(state, batch, xi_k, key, grad_fn, hp,
                                       up_plan, down_plan,
                                       participation_mask=mask_t,
                                       loss_fn=loss_fn)
        return new_state, agg, dict(metrics, events=None)
    part = np.ones((n,), np.float32) if participation_mask is None \
        else np.asarray(participation_mask, np.float32)
    new_state, new_agg, loss, events = _async_agg_fresh(
        state, agg, key, part, np.asarray(lat), np.asarray(drp, np.float32),
        np.asarray(crs, np.float32), n=n, q=q, hp=hp, up_plan=up_plan,
        down_plan=down_plan, fault_plan=fault_plan, batch=batch,
        grad_fn=grad_fn, loss_fn=loss_fn, participation_mask=mask_t)
    return new_state, new_agg, {"loss": loss, "branch": 1, "events": events}


def rollout_l2gd_async(key, state: L2GDState, hp: L2GDHyper, batches,
                       xi_trace: Optional[Any] = None, *, grad_fn: Callable,
                       fault_plan: Optional["FaultPlan"] = None,
                       steps: Optional[int] = None, client_comp=Identity(),
                       master_comp=Identity(),
                       batch_axis: Optional[int] = 0,
                       participation: Optional[float] = None,
                       agg_state: Optional[AsyncAggState] = None,
                       loss_fn: Optional[Callable] = None):
    """K steps of Algorithm 1 under the fault model.

    :func:`repro_torch.core.rollout.rollout_l2gd`'s contract with a
    ``fault_plan`` (:class:`repro_torch.fl.faults.FaultPlan`; None = the
    null plan) and the server carry ``agg_state`` (None builds an empty
    delay buffer; chunked callers thread the returned one, as they do
    ``state`` — both index the same global step and round clocks, so
    chunking is invisible).  The fault draws are the fourth stream, a
    function of (key, global step) alone.

    Returns ``(final_state, final_agg_state, AsyncRolloutTrace)``."""
    # function-local: repro_torch.fl imports the core package
    from repro_torch.fl.faults import FaultPlan, fault_draws
    fault_plan = fault_plan if fault_plan is not None else FaultPlan()
    length = _rollout_length(batches, batch_axis, xi_trace, steps)
    n = int(hp.n)
    up_plan = _resolve_uplink(client_comp)
    down_plan = as_plan(master_comp)
    if agg_state is None:
        agg_state = init_async_state(state.params, up_plan, fault_plan)
    xis, subs = window_streams(key, hp.p, state.step, length, xi_trace)
    masks = window_masks(key, n, participation, state.step, length)
    q = fault_plan.quorum_count(
        n if participation is None else participant_count(n, participation))
    lats, drps, crss = fault_draws(
        prng.split(key)[0], state.step + np.arange(length), n, fault_plan)

    device = tree_leaves(state.params)[0].device
    losses = torch.empty((length,), dtype=torch.float32, device=device)
    events = torch.zeros((length, len(EVENT_FIELDS)), dtype=torch.int32,
                         device=device)
    branches = np.empty((length,), np.int32)
    agg = agg_state
    for i in range(length):
        batch = batches if batch_axis is None else \
            tree_map(lambda a: a[i], batches)
        state, agg, metrics = async_l2gd_step(
            state, agg, batch, int(xis[i]), subs[i], lats[i], drps[i],
            crss[i], grad_fn=grad_fn, hp=hp, up_plan=up_plan,
            down_plan=down_plan, fault_plan=fault_plan, q=q,
            participation_mask=None if masks is None else masks[i],
            loss_fn=loss_fn)
        losses[i] = metrics["loss"]
        branches[i] = metrics["branch"]
        if metrics["events"] is not None:
            events[i] = metrics["events"]
    return state, agg, AsyncRolloutTrace(
        losses=losses, xis=xis, branches=branches,
        n_local=int(np.sum(branches == 0)),
        n_agg_comm=int(np.sum(branches == 1)),
        n_agg_cached=int(np.sum(branches == 2)), events=events)
