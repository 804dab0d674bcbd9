"""Protocol driver for compressed L2GD (Algorithm 1) — the counterpart of
``repro.fl.l2gd_driver.run_l2gd``.

``mode="scan"`` (default) runs the protocol in chunks of
:func:`repro_torch.core.rollout.rollout_l2gd`: each chunk's xi draws and
step keys come from one host-side pass, no step waits on the device, and
the host fetches the chunk's losses once at its end, replays the xi
trace into the :class:`~repro_torch.fl.ledger.BitsLedger` and runs
``eval_fn``.  ``mode="host"`` is the per-step reference loop (one
blocking loss fetch per step, rounds recorded as they happen).  Both
follow the reference's determinism contract: ``xi_key, noise_key =
split(key)``, step k draws ``xi_k = bernoulli(fold_in(xi_key, k), p)``
and compresses with ``fold_in(noise_key, k)``.

The ledger charges ``uplink_plan.round_bits()`` per client and
``downlink_plan.round_bits()`` per round (DESIGN.md §3); a sampled round
(``participation=``) costs s/n of that, and a faulty one (``faults=``,
the async engine of :mod:`repro_torch.core.async_engine`) is charged
from its realized delivery counts.  A mixed fleet uplink
(:class:`repro_torch.fl.fleet.FleetPlan`, DESIGN.md §13) is charged its
per-client vector ``round_bits_vector()``.

Checkpoints (scan mode, DESIGN.md §14): ``checkpoint_policy=`` (a
:class:`repro_torch.checkpoint.CheckpointPolicy`) snapshots the chunk
boundaries' returned carries through the sharded background
:class:`~repro_torch.checkpoint.CheckpointManager`; ``resume_from=``
continues from one, bit for bit with the uninterrupted run, since every
random stream is keyed by the global step the state carries.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.codec import CompressionPlan, as_plan
from repro_torch.core.compressors import Identity
from repro_torch.core.l2gd import L2GDHyper, init_state, l2gd_step
from repro_torch.core.rollout import (participant_count, rollout_l2gd,
                                      window_masks, window_streams)
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.fl.fleet import FleetPlan, fleet_from_plans, resolve_uplink
from repro_torch.fl.ledger import BitsLedger, per_client_uplink
from repro_torch.kernels.dispatch import resolve_device

__all__ = ["L2GDRun", "run_l2gd"]

MODES = ("scan", "host")

# default chunk when per-step batches are stacked on the device (no
# eval_fn sets the boundary): bounds the stacked-batch memory
_DEFAULT_BATCH_CHUNK = 512


@dataclasses.dataclass
class L2GDRun:
    state: object
    ledger: BitsLedger
    losses: list                 # (step, mean client loss) at EVERY step
    evals: list                  # (steps completed, eval value) if eval_fn
    n_local: int = 0
    n_agg_comm: int = 0
    n_agg_cached: int = 0
    xis: Optional[np.ndarray] = None   # realized xi trace (both modes)
    fault_stats: Optional[dict] = None  # {event: total} when faults= given


def _resolve_plans(client_comp, master_comp, plan, one_client):
    """(uplink, downlink) plans, bound to one client's shapes.  The
    uplink may be a :class:`repro_torch.fl.fleet.FleetPlan` (as
    ``client_comp``, ``plan`` or ``plan[0]``), or a length-n sequence of
    per-client plans (``client_comp``; :func:`repro_torch.fl.fleet.
    fleet_from_plans`); a uniform fleet unwraps to its single plan at
    once.  The downlink is always one broadcast plan."""
    if isinstance(client_comp, (list, tuple)):
        client_comp = fleet_from_plans(client_comp)
    if plan is None:
        up_plan = client_comp if isinstance(client_comp, FleetPlan) \
            else as_plan(client_comp)
        down_plan = as_plan(master_comp)
    elif isinstance(plan, (tuple, list)):
        up_plan, down_plan = plan
    else:
        up_plan, down_plan = plan, as_plan(master_comp)
    if not isinstance(up_plan, (CompressionPlan, FleetPlan)) \
            or not isinstance(down_plan, CompressionPlan):
        raise TypeError("plan must be a CompressionPlan (or a FleetPlan "
                        "uplink) or an (uplink, downlink) pair; the "
                        "downlink is always a single CompressionPlan")
    if isinstance(up_plan, FleetPlan):
        up_plan = resolve_uplink(up_plan.bind(one_client))
    if isinstance(up_plan, CompressionPlan) and up_plan.specs is None:
        up_plan = up_plan.bind(one_client)
    if down_plan.specs is None:
        down_plan = down_plan.bind(one_client)
    return up_plan, down_plan


def _constant_batches(batch_fn, steps) -> bool:
    """True iff batch_fn returns the SAME leaf objects for every step
    (the ``lambda k: (X, Y)`` idiom): the rollout then reuses one batch."""
    if steps < 2:
        return True
    l0, l1 = tree_leaves(batch_fn(0)), tree_leaves(batch_fn(1))
    return len(l0) == len(l1) and all(a is b for a, b in zip(l0, l1))


def run_l2gd(key, params_stacked, grad_fn: Callable, hp: L2GDHyper,
             batch_fn: Callable[[int], object], steps: int,
             client_comp=Identity(), master_comp=Identity(), plan=None,
             eval_fn: Optional[Callable] = None, eval_every: int = 50,
             mode: str = "scan", chunk: Optional[int] = None,
             xi_trace=None, participation: Optional[float] = None,
             faults=None, checkpoint_policy=None, resume_from=None,
             resume_step: Optional[int] = None,
             allow_lossy_resume: bool = False,
             local_steps: int = 1, loss_fn: Optional[Callable] = None,
             device=None) -> L2GDRun:
    """Run Algorithm 1 for ``steps`` iterations on ``device`` (default
    ``cuda``; raises without a CUDA device unless one is named).

    ``key`` is the protocol key (two uint32 words, e.g.
    :func:`repro_torch.core.prng.PRNGKey`); ``params_stacked`` a tree of
    tensors or arrays with a leading client axis n; ``grad_fn(params,
    batch) -> (losses (n,), grads)`` over the stacked client axis;
    ``batch_fn(step)`` the step's stacked batch (deterministic per step).
    ``plan`` is an uplink CompressionPlan or an (uplink, downlink) pair;
    ``client_comp`` (or the uplink) may be a FleetPlan or a length-n
    sequence of per-client plans (heterogeneous fleets);
    ``xi_trace`` forces the protocol realization; ``eval_fn(params)`` runs
    every ``eval_every`` steps (at chunk boundaries in scan mode);
    ``loss_fn(params, batch) -> losses (n,)`` (optional) gives the
    aggregation steps' losses without a backward.

    ``participation`` (optional fraction f in (0, 1]) samples s =
    ``participant_count(n, f)`` participants for every aggregation step
    (the same masks in both modes); the ledger charges each round at
    s/n.  ``faults`` (optional :class:`repro_torch.fl.faults.FaultPlan`)
    runs the protocol on the async fault engine
    (:func:`repro_torch.core.async_engine.rollout_l2gd_async`; scan mode
    and ``local_steps == 1`` only, as in the reference): the ledger is
    replayed from the realized delivery counts, honouring
    ``faults.charge_dropped``, and ``run.fault_stats`` totals the event
    counters.  ``FaultPlan()`` (the null plan) equals ``faults=None`` in
    value.

    Checkpoints (scan mode only): ``checkpoint_policy`` snapshots
    (state, the async engine's delay buffer, key, ledger, traces,
    counters) every ``every_n_chunks`` chunk boundaries and at the last
    one; the run blocks only for the copy to the host, and joins the
    commit worker before it returns.  ``resume_from`` (a manager, root
    directory or policy; ``resume_step`` picks a step, default the
    newest) restores a snapshot and continues; a config or key mismatch
    raises ``ValueError`` before any step, and a delta snapshot is
    refused unless ``allow_lossy_resume=True``."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; have {MODES}")
    if faults is not None and mode != "scan":
        raise ValueError("faults= requires mode='scan': the async engine "
                         "is the rollout (repro_torch.core.async_engine)")
    if faults is not None and int(local_steps) != 1:
        raise ValueError("local_steps > 1 is not supported on the async "
                         "fault engine yet (its round clock assumes one "
                         "gradient pass per local step)")
    device = resolve_device(device)
    key = np.asarray(key, np.uint32)
    params = tree_map(lambda a: torch.as_tensor(a).to(device), params_stacked)
    del params_stacked
    run = L2GDRun(init_state(params), BitsLedger(int(hp.n)), [], [])
    one_client = tree_map(lambda a: a[0], params)
    del params
    up_plan, down_plan = _resolve_plans(client_comp, master_comp, plan,
                                        one_client)
    del one_client   # the plans keep shapes only
    if isinstance(up_plan, CompressionPlan):
        up_bits = up_plan.round_bits()
    else:   # a mixed fleet charges its per-client vector
        if up_plan.n_clients != int(hp.n):
            raise ValueError(f"fleet covers {up_plan.n_clients} clients; "
                             f"hp.n = {int(hp.n)}")
        up_bits = up_plan.round_bits_vector()
    down_bits = down_plan.round_bits()

    if xi_trace is not None:
        xi_trace = np.asarray(xi_trace, np.int32)
        if xi_trace.shape != (steps,):
            raise ValueError(f"xi_trace must have shape ({steps},), "
                             f"got {xi_trace.shape}")
    if steps <= 0:
        run.xis = np.zeros((0,), np.int32)
        return run

    signature = resume = None
    if checkpoint_policy is not None or resume_from is not None:
        if mode != "scan":
            raise ValueError("checkpoint_policy=/resume_from= require "
                             "mode='scan' (the host loop has no chunk "
                             "boundaries to snapshot at)")
        from repro_torch.checkpoint.resume import rollout_signature
        signature = rollout_signature(
            steps=steps, n=int(hp.n), up_bits=up_bits, down_bits=down_bits,
            participation=participation, faults=faults)
    if resume_from is not None:
        from repro_torch.checkpoint.resume import (load_rollout_checkpoint,
                                                   validate_resume)
        run.state = None     # the snapshot's state replaces the initial one
        resume = load_rollout_checkpoint(resume_from, step=resume_step,
                                         allow_lossy=allow_lossy_resume,
                                         device=device)
        validate_resume(resume, signature, key)
        run.state = resume.state
        run.ledger = BitsLedger.from_state_dict(resume.ledger_state)
        run.losses = list(resume.losses)
        run.evals = list(resume.evals)
        run.n_local = resume.n_local
        run.n_agg_comm = resume.n_agg_comm
        run.n_agg_cached = resume.n_agg_cached
        run.fault_stats = None if resume.fault_stats is None \
            else dict(resume.fault_stats)

    def to_device(batch):
        return tree_map(lambda a: torch.as_tensor(a).to(device), batch)

    const = _constant_batches(batch_fn, steps)
    if const:   # one batch for every step: moved to the device once
        fixed = to_device(batch_fn(0))
        batch_at = lambda k: fixed
    else:
        batch_at = lambda k: to_device(batch_fn(k))
    if mode == "host":
        _run_host(run, key, grad_fn, hp, batch_at, steps, up_plan,
                  down_plan, up_bits, down_bits, eval_fn, eval_every,
                  xi_trace, participation, local_steps, loss_fn)
    else:
        _run_scan(run, key, grad_fn, hp, batch_at, const, steps, up_plan,
                  down_plan, up_bits, down_bits, eval_fn, eval_every, chunk,
                  xi_trace, participation, faults, local_steps, loss_fn,
                  checkpoint_policy, signature, resume)
    return run


def _checkpoint_chunk(policy, signature, key, done, xi_prev, state, agg,
                      run, xis_all) -> None:
    """Snapshot one chunk boundary under the policy's manager: the
    RETURNED carries, copied to the host before ``save`` returns, so the
    background commit never sees the next chunk's in-place writes."""
    from repro_torch.checkpoint.resume import pack_snapshot
    tree = pack_snapshot(key=key, done=done, xi_prev=xi_prev, state=state,
                         ledger=run.ledger, run=run,
                         xis=np.concatenate(xis_all) if xis_all
                         else np.zeros((0,), np.int32),
                         signature=signature, agg=agg, mode=policy.mode,
                         delta_plan=policy.delta_plan)
    policy.resolve().save(done, tree, wait=policy.wait)


def _take_state(run: L2GDRun):
    """Hand the run's state to a step and drop the run's reference, so
    the model-sized buffers of a finished step are freed as soon as the
    next one replaces them (at most two generations of params live)."""
    state, run.state = run.state, None
    return state


def _run_host(run, key, grad_fn, hp, batch_at, steps, up_plan,
              down_plan, up_bits, down_bits, eval_fn, eval_every, xi_trace,
              participation, local_steps, loss_fn):
    """Per-step reference loop: one blocking loss fetch per step."""
    xis, subs = window_streams(key, hp.p, 0, steps, xi_trace)
    n = int(hp.n)
    masks = window_masks(key, n, participation, 0, steps)
    scale = 1.0 if participation is None else \
        participant_count(n, participation) / n
    # the replay's normalization of a fleet's per-client vector, so the
    # host loop's ledger equals the replayed one bit for bit
    up_mean = per_client_uplink(up_bits, n)
    device = tree_leaves(run.state.params)[0].device
    xi_prev = 1  # Algorithm 1 input: xi_{-1} = 1
    for k in range(steps):
        xi = int(xis[k])
        mask = None if masks is None else \
            torch.from_numpy(masks[k]).to(device)
        run.state, metrics = l2gd_step(_take_state(run), batch_at(k), xi,
                                       subs[k], grad_fn, hp, up_plan,
                                       down_plan, participation_mask=mask,
                                       local_steps=local_steps,
                                       loss_fn=loss_fn)
        run.losses.append((k, float(metrics["loss"])))
        if xi == 0:
            run.n_local += 1
        elif xi_prev == 0:
            run.n_agg_comm += 1
            run.ledger.record_round(scale * up_mean, scale * down_bits,
                                    step=k)
        else:
            run.n_agg_cached += 1
        xi_prev = xi
        if eval_fn is not None and (k + 1) % eval_every == 0:
            run.evals.append((k + 1, float(eval_fn(run.state.params))))
    run.xis = xis


def _run_scan(run, key, grad_fn, hp, batch_at, const, steps, up_plan,
              down_plan, up_bits, down_bits, eval_fn, eval_every, chunk,
              xi_trace, participation, faults, local_steps, loss_fn,
              policy=None, signature=None, resume=None):
    """Chunked rollout: the chunk boundary is the only place the host
    reads device data (losses, fault events, eval_fn) and snapshots
    (``policy``).  With ``faults`` the chunks are async rollouts, the
    server's delay buffer threaded across them like the state, and the
    ledger replays the realized delivery counts.  ``resume`` (a
    RolloutSnapshot) starts from its boundary, the delay buffer too."""
    agg = None
    if faults is not None:
        from repro_torch.core.async_engine import (EVENT_FIELDS,
                                                   init_async_state,
                                                   rollout_l2gd_async)
        if resume is not None and resume.agg is not None:
            agg = resume.agg   # stragglers mature on their own rounds
        else:
            agg = init_async_state(run.state.params, up_plan, faults)
        totals = {name: 0 for name in EVENT_FIELDS}
        if resume is not None and resume.fault_stats is not None:
            totals.update({k: int(v) for k, v in resume.fault_stats.items()})
    if chunk is None:
        if eval_fn is not None:
            chunk = eval_every
        elif const:
            chunk = steps
        else:
            chunk = min(steps, _DEFAULT_BATCH_CHUNK)
    chunk = max(1, min(int(chunk), steps))

    done, xi_prev, xis_all = 0, 1, []
    if resume is not None:
        done, xi_prev = resume.done, resume.xi_prev
        if resume.xis.size:
            xis_all.append(resume.xis)
    while done < steps:
        length = min(chunk, steps - done)
        if const:
            batches = batch_at(done)
        else:
            batches = tree_map(lambda *xs: torch.stack(xs),
                               *[batch_at(k)
                                 for k in range(done, done + length)])
        forced = None if xi_trace is None else xi_trace[done:done + length]
        kw = dict(grad_fn=grad_fn, steps=length, client_comp=up_plan,
                  master_comp=down_plan, batch_axis=None if const else 0,
                  participation=participation, loss_fn=loss_fn)
        if faults is None:
            run.state, trace = rollout_l2gd(
                key, _take_state(run), hp, batches, forced,
                local_steps=local_steps, **kw)
        else:
            run.state, agg, trace = rollout_l2gd_async(
                key, _take_state(run), hp, batches, forced,
                fault_plan=faults, agg_state=agg, **kw)

        # the chunk boundary: ONE fetch of the losses (and the events)
        losses = trace.losses.cpu().numpy()
        xis_all.append(trace.xis)
        run.losses.extend((done + i, float(losses[i])) for i in range(length))
        run.n_local += trace.n_local
        run.n_agg_comm += trace.n_agg_comm
        run.n_agg_cached += trace.n_agg_cached
        if faults is None:
            xi_prev = run.ledger.replay_xi_trace(
                trace.xis, up_bits, down_bits, xi_prev=xi_prev,
                start_step=done, participation=participation)
        else:
            events = trace.events.cpu().numpy()
            for i, name in enumerate(EVENT_FIELDS):
                totals[name] += int(events[:, i].sum())
            xi_prev = run.ledger.replay_fault_trace(
                trace.xis, events[:, 0], events[:, 1], up_bits, down_bits,
                xi_prev=xi_prev, start_step=done,
                charge_dropped=faults.charge_dropped)
        done += length
        if eval_fn is not None and done % eval_every == 0:
            run.evals.append((done, float(eval_fn(run.state.params))))
        # the cadence counts GLOBAL chunks, so a resumed run snapshots the
        # boundaries of the uninterrupted one
        if policy is not None and \
                ((done // chunk) % policy.every_n_chunks == 0
                 or done == steps):
            if faults is not None:
                run.fault_stats = dict(totals)
            _checkpoint_chunk(policy, signature, key, done, xi_prev,
                              run.state, agg, run, xis_all)
    if policy is not None:
        # a failed background commit (the last one too) raises here,
        # before the run reports success
        policy.resolve().wait_until_finished()
    run.xis = np.concatenate(xis_all) if xis_all \
        else np.zeros((0,), np.int32)
    if faults is not None:
        run.fault_stats = totals
