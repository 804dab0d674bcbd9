"""Heterogeneous fleets: per-cohort compression plans over one federation
— the counterpart of ``repro.fl.fleet`` (DESIGN.md §13).

A :class:`FleetPlan` is a small table of cohort plans plus a static
per-client cohort assignment, pure Python configuration like
:class:`~repro_torch.core.codec.CompressionPlan` itself.

  * :func:`as_fleet_plan` promotes a single plan (or plain compressor)
    to a one-cohort fleet.
  * :func:`resolve_uplink` is the coercion every engine entry point
    applies to its uplink: plain compressors and plans become a
    CompressionPlan; a UNIFORM fleet unwraps to its single plan, so the
    engines run the single-plan code and the uniform-fleet keystone holds
    by construction; only a MIXED fleet takes the per-cohort paths below.
  * The ledger charges per-client wire costs:
    :meth:`FleetPlan.round_bits_vector` feeds
    :meth:`repro_torch.fl.ledger.BitsLedger.replay_xi_trace`.

Mixed-fleet aggregation: clients are grouped by cohort (the assignment
is static).  A flat or packed cohort encodes its members in one batched
call of its plan and folds them on the O(d) server accumulator
(:func:`repro_torch.core.flatbuf.reduce_payload_acc`); a leafwise cohort
applies its plan and takes the NaN-safe weighted client sum.  The cohort
partial sums (one-model float32 trees) are added in ``used_cohorts``
order and divided by the total participant weight once.  Client i draws
from ``split(k_clients, n)[i]`` whatever cohort it is in.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.codec import CompressionPlan, as_plan
from repro_torch.core.tree import tree_map

__all__ = ["FleetPlan", "as_fleet_plan", "fleet_from_plans",
           "resolve_uplink", "cohort_label",
           "CohortBatch", "fleet_encode", "fleet_finite_mask",
           "fleet_weighted_sum", "fleet_mean"]


def cohort_label(plan: CompressionPlan) -> str:
    """Short deterministic label of one cohort's plan: codec name, qsgd
    levels, and an ``n`` suffix for the narrow sub-byte wire."""
    comp = plan.codec
    name = getattr(comp, "name", type(comp).__name__.lower())
    levels = getattr(comp, "levels", None)
    if name == "qsgd" and levels is not None:
        name = f"qsgd{levels}"
    if getattr(plan, "narrow", False):
        name += "n"
    return name


@dataclasses.dataclass(frozen=True, eq=False)
class FleetPlan:
    """Cohort -> :class:`CompressionPlan` table + static per-client
    assignment: ``assignment[i]`` is client i's cohort id, so
    ``len(assignment)`` is the fleet size n.  ``names`` optionally labels
    the cohorts (default :func:`cohort_label` of each plan)."""

    cohorts: Tuple[CompressionPlan, ...]
    assignment: Tuple[int, ...]
    names: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        if not self.cohorts:
            raise ValueError("FleetPlan needs at least one cohort plan")
        for c, p in enumerate(self.cohorts):
            if not isinstance(p, CompressionPlan):
                raise TypeError(f"cohort {c} is not a CompressionPlan: "
                                f"{p!r} (coerce with repro_torch.core.codec."
                                "as_plan / make_plan)")
        object.__setattr__(self, "cohorts", tuple(self.cohorts))
        assignment = tuple(int(a) for a in self.assignment)
        for i, a in enumerate(assignment):
            if not 0 <= a < len(self.cohorts):
                raise ValueError(f"client {i} assigned to cohort {a}; "
                                 f"have {len(self.cohorts)} cohorts")
        object.__setattr__(self, "assignment", assignment)
        if self.names is not None:
            names = tuple(str(s) for s in self.names)
            if len(names) != len(self.cohorts):
                raise ValueError(f"{len(names)} names for "
                                 f"{len(self.cohorts)} cohorts")
            object.__setattr__(self, "names", names)

    # -- shape ---------------------------------------------------------------
    @property
    def n_clients(self) -> int:
        return len(self.assignment)

    @property
    def n_cohorts(self) -> int:
        return len(self.cohorts)

    @property
    def used_cohorts(self) -> Tuple[int, ...]:
        """Cohort ids with at least one client, ascending: the order in
        which every mixed-fleet fold adds the cohort partial sums."""
        return tuple(sorted(set(self.assignment)))

    @property
    def is_uniform(self) -> bool:
        """True when every client lives in one cohort (the keystone case
        that unwraps to the single-plan path)."""
        return len(set(self.assignment)) <= 1

    @property
    def uniform_plan(self) -> CompressionPlan:
        """The single plan of a uniform fleet (an empty fleet reports
        cohort 0's)."""
        if not self.is_uniform:
            raise ValueError("mixed fleet has no single uniform plan; "
                             "check FleetPlan.is_uniform first")
        return self.cohorts[self.assignment[0] if self.assignment else 0]

    # -- lookups -------------------------------------------------------------
    def cohort_of(self, client: int) -> int:
        return self.assignment[client]

    def plan_for(self, client: int) -> CompressionPlan:
        return self.cohorts[self.assignment[client]]

    def clients_of(self, cohort: int) -> Tuple[int, ...]:
        """Ascending client indices of one cohort."""
        return tuple(i for i, a in enumerate(self.assignment) if a == cohort)

    def cohort_name(self, cohort: int) -> str:
        if self.names is not None:
            return self.names[cohort]
        return cohort_label(self.cohorts[cohort])

    @property
    def mix(self) -> str:
        """Mix label of the used cohorts, e.g. ``identity-natural-qsgd4n``."""
        return "-".join(self.cohort_name(c) for c in self.used_cohorts)

    # -- binding / accounting -------------------------------------------------
    def bind(self, params) -> "FleetPlan":
        """Bind every cohort plan to one model's shapes (enables
        ``round_bits``)."""
        return dataclasses.replace(
            self, cohorts=tuple(p.bind(params) for p in self.cohorts))

    def round_bits(self, client: int) -> float:
        """Exact wire bits of ONE message from ``client``."""
        return self.plan_for(client).round_bits()

    def round_bits_vector(self) -> Tuple[float, ...]:
        """Per-client ``round_bits`` as a length-n tuple (the ledger's
        ``uplink_bits`` argument); each cohort's cost is evaluated once."""
        per_cohort = {c: self.cohorts[c].round_bits()
                      for c in self.used_cohorts}
        return tuple(per_cohort[a] for a in self.assignment)

    def total_round_bits(self) -> float:
        """sum_i round_bits(i): one full-participation round's uplink
        total (what the ledger conserves and the controller budgets)."""
        return float(sum(self.round_bits_vector()))


def as_fleet_plan(plan_or_fleet, n_clients: int, params=None) -> FleetPlan:
    """Promote a single plan or compressor to a one-cohort fleet of
    ``n_clients``; a :class:`FleetPlan` is size-checked and returned
    (bound to ``params`` when given)."""
    if isinstance(plan_or_fleet, FleetPlan):
        if plan_or_fleet.n_clients != int(n_clients):
            raise ValueError(f"fleet covers {plan_or_fleet.n_clients} "
                             f"clients, expected {n_clients}")
        return plan_or_fleet.bind(params) if params is not None \
            else plan_or_fleet
    plan = as_plan(plan_or_fleet, params=params)
    return FleetPlan(cohorts=(plan,), assignment=(0,) * int(n_clients))


def _plan_key(plan: CompressionPlan):
    """Structural identity of a plan for cohort dedup: codec (a frozen
    dataclass), transport, bucket, narrow; not the bound shapes."""
    return (plan.codec, plan.transport, plan.bucket, plan.narrow)


def fleet_from_plans(plans) -> FleetPlan:
    """A :class:`FleetPlan` from a length-n PER-CLIENT plan vector.
    Structurally equal plans (:func:`_plan_key`) dedupe into one cohort,
    so n copies of one plan become the uniform fleet and clients that
    share a recipe fold in one cohort partial sum.  Entries may be plans
    or plain compressors."""
    plans = [as_plan(p) for p in plans]
    if not plans:
        raise ValueError("fleet_from_plans needs at least one plan")
    cohorts, assignment, seen = [], [], {}
    for p in plans:
        k = _plan_key(p)
        if k not in seen:
            seen[k] = len(cohorts)
            cohorts.append(p)
        assignment.append(seen[k])
    return FleetPlan(cohorts=tuple(cohorts), assignment=tuple(assignment))


def resolve_uplink(comp, transport: Optional[str] = None):
    """Plain compressors and plans -> ``as_plan``; uniform fleets ->
    their single plan; mixed fleets -> the fleet itself.  A length-n
    sequence of plans is a per-client plan vector
    (:func:`fleet_from_plans`), then the same rule."""
    if isinstance(comp, (list, tuple)):
        comp = fleet_from_plans(comp)
    if isinstance(comp, FleetPlan):
        if comp.is_uniform:
            return comp.uniform_plan
        return comp
    return as_plan(comp, transport)


# ---------------------------------------------------------------------------
# mixed-fleet aggregation: cohort-grouped encode + fold
# ---------------------------------------------------------------------------

class CohortBatch(NamedTuple):
    """One cohort's encoded contribution to a round.  ``kind`` selects
    the fold: ``"fused"`` carries the cohort's stacked sanitized wire
    payload (flat / packed plans), ``"tree"`` its stacked decoded
    contribution tree (leafwise plans).  ``idx`` is the cohort's client
    indices, ``fin`` its (len(idx),) finite-client mask."""

    cohort: int
    idx: Tuple[int, ...]
    kind: str
    data: Any
    fin: torch.Tensor


def fleet_encode(fleet: FleetPlan, client_keys, params_stacked):
    """Encode a client-stacked tree under a mixed fleet: one
    :class:`CohortBatch` per used cohort.  ``client_keys`` is the
    synchronous engines' (n, 2) key schedule ``split(k_clients, n)``:
    client i uses ``client_keys[i]`` under ``fleet.plan_for(i)``."""
    from repro_torch.core import flatbuf
    from repro_torch.core.aggregation import stacked_finite_mask
    keys = np.asarray(client_keys)
    batches = []
    for c in fleet.used_cohorts:
        plan = fleet.cohorts[c]
        idx = fleet.clients_of(c)
        keys_c = keys[list(idx)]
        sub = tree_map(lambda a: a[list(idx)], params_stacked)
        if plan.transport in ("flat", "packed"):
            payload = plan.encode(keys_c, sub)
            fin = flatbuf.payload_finite_mask(payload)
            payload = flatbuf.sanitize_payload(payload, fin)
            batches.append(CohortBatch(c, idx, "fused", payload, fin))
        else:
            contrib = plan.apply(keys_c, sub)
            fin = stacked_finite_mask(contrib)
            batches.append(CohortBatch(c, idx, "tree", contrib, fin))
        del sub
    return batches


def fleet_finite_mask(batches, n: int) -> torch.Tensor:
    """(n,) 0/1 float32 over the whole fleet: each cohort's finite mask
    at its clients' indices."""
    fin = torch.zeros((n,), dtype=torch.float32, device=batches[0].fin.device)
    for b in batches:
        fin[list(b.idx)] = b.fin.to(fin.device)
    return fin


def fleet_weighted_sum(batches, weights: torch.Tensor):
    """``sum_c sum_{i in c} w_i * decode_i`` as one one-model float32
    tree: fused cohorts fold on the O(d) accumulator, leafwise cohorts on
    the NaN-safe weighted client sum; cohort partial sums are added in
    ``used_cohorts`` order.  ``weights`` is the global (n,) weight
    vector; each cohort takes its clients' entries."""
    from repro_torch.core import flatbuf
    from repro_torch.core.aggregation import weighted_client_sum
    total = None
    for b in batches:
        w_c = weights[list(b.idx)]
        if b.kind == "fused":
            layout = b.data.layout
            part = flatbuf.unravel(
                layout, flatbuf.unbucketize(
                    flatbuf.reduce_payload_acc(b.data, w_c), layout.d))
        else:
            part = weighted_client_sum(b.data, w_c)
        part = tree_map(lambda a: a.to(torch.float32), part)
        if total is None:
            total = part
        else:
            tree_map(lambda t, a: t.add_(a), total, part)
        del part
    return total


def fleet_mean(fleet: FleetPlan, client_keys, params_stacked, mask=None):
    """The mixed-fleet masked mean ``sum_i m_i C_i(x_i) / sum_i m_i``
    over per-cohort plans, with the single-plan
    :func:`repro_torch.core.flatbuf.reduce_payload_mean`'s semantics:
    non-finite clients leave the numerator and the denominator, an empty
    support clamps the denominator to 1 (the zeros tree), and the result
    takes the parameters' dtypes.  One division by the total weight."""
    n = fleet.n_clients
    batches = fleet_encode(fleet, client_keys, params_stacked)
    fin = fleet_finite_mask(batches, n)
    w = fin if mask is None else mask.reshape(-1).to(torch.float32) * fin
    denom = torch.sum(w)
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    total = fleet_weighted_sum(batches, w)
    del batches
    return tree_map(lambda s, a: (s / safe).to(a.dtype), total,
                    params_stacked)
