"""Bandwidth-budget controller: pick each cohort's qsgd level from
ledger feedback, deterministically — the counterpart of
``repro.fl.controller`` (plain Python, copied).

The adaptive half of the heterogeneous-fleet refactor (DESIGN.md §13):
given a per-round uplink bit budget for the WHOLE fleet, choose each
adjustable cohort's QSGD level so the fleet's full-participation round
cost ``sum_i round_bits(i)`` fits the budget — and when earlier rounds
underspent (partial participation, cached-target rounds, drops), spend
the accumulated allowance on higher levels.

Determinism contract (test-pinned): :meth:`BandwidthBudgetController.
next_fleet` is a PURE function of ``(budget, fleet, ledger history)`` —
no RNG, no wall clock, no floating accumulation order that differs
between replays.  Replaying the same run therefore reproduces the same
level schedule bit-exactly, which keeps the ledger replayable too: the
controller reads the ledger, never writes it.

What is adjustable: cohorts whose plan is flat/packed QSGD (the codec
with a continuous quality/bits knob).  Identity, natural, terngrad,
sparse cohorts keep their plans verbatim — their cost is part of the
budget's fixed floor.  Levels come from a static menu; levels <= 7 ride
the narrow sub-byte wire (``make_plan(..., narrow=True)``, ~4.02
bits/param at bucket 2048) and levels <= 1 the 2-bit wire, so the menu
spans a genuine ~2..8 bits/param range instead of int8-always.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.codec import CompressionPlan, make_plan
from repro_torch.fl.fleet import FleetPlan
from repro_torch.fl.ledger import BitsLedger

__all__ = ["BandwidthBudgetController", "qsgd_level_plan"]

#: default level menu, ascending fidelity: 2-bit / 4-bit narrow tiers,
#: then the int8 wire
DEFAULT_LEVELS = (1, 3, 7, 15, 31, 63, 127)


def _is_adjustable(plan: CompressionPlan) -> bool:
    return plan.transport in ("flat", "packed") \
        and getattr(plan.codec, "name", None) == "qsgd"


def qsgd_level_plan(template: CompressionPlan, levels: int
                    ) -> CompressionPlan:
    """A copy of a flat/packed QSGD ``template`` plan at ``levels``,
    narrow-wired whenever the level fits sub-byte codes (levels <= 7).
    Preserves transport/bucket/specs — ``round_bits()`` works on the
    result without rebinding."""
    codec = dataclasses.replace(template.codec, levels=int(levels))
    plan = make_plan(codec, transport=template.transport,
                     bucket=template.bucket, narrow=int(levels) <= 7)
    return dataclasses.replace(plan, specs=template.specs)


@dataclasses.dataclass(frozen=True)
class BandwidthBudgetController:
    """Deterministic per-round uplink budgeter.

    ``budget_bits_per_round`` is the fleet-TOTAL uplink allowance of one
    full-participation round (the ledger's conservation quantity,
    ``n * uplink_bits_per_client`` per round).  ``levels_menu`` is the
    ascending QSGD level ladder the controller may assign.

    :meth:`next_fleet` implements a greedy water-filling over the menu:

      1. allowance = ``budget * (rounds_so_far + 1) - bits already spent``
         (from the ledger; no ledger -> one round's budget).  Underspent
         history rolls forward, overspent history tightens the next
         round — feedback without any controller-side state.
      2. every adjustable (flat/packed qsgd) cohort starts at the menu
         minimum; non-adjustable cohorts keep their plans (fixed floor).
      3. while the fleet's full-participation ``sum_i round_bits(i)``
         stays within the allowance, upgrade the adjustable cohort with
         the LOWEST current level one menu step (ties: lowest cohort
         id) — phones catch up before desktops get int8.

    Steps 1–3 read only ``(budget, fleet, ledger)`` and iterate in a
    fixed order, so the schedule replays bit-exactly (module contract).
    Even the floor allocation may exceed a tiny allowance; the floor is
    still returned (the protocol cannot send less than the menu minimum
    — the ledger will report the overrun and the NEXT round tightens).
    """

    budget_bits_per_round: float
    levels_menu: Tuple[int, ...] = DEFAULT_LEVELS

    def __post_init__(self):
        if self.budget_bits_per_round <= 0:
            raise ValueError("budget_bits_per_round must be positive")
        menu = tuple(int(v) for v in self.levels_menu)
        if not menu or list(menu) != sorted(set(menu)):
            raise ValueError(f"levels_menu must be strictly ascending and "
                             f"non-empty, got {self.levels_menu}")
        if menu[-1] > 127:
            raise ValueError("levels above 127 do not fit the flat "
                             "engine's int8 wire")
        object.__setattr__(self, "levels_menu", menu)

    def allowance(self, ledger: Optional[BitsLedger] = None) -> float:
        """Uplink bits available for the NEXT round: the cumulative
        budget through that round minus the fleet total already charged
        (``n * uplink_bits_per_client``)."""
        if ledger is None:
            return float(self.budget_bits_per_round)
        spent = ledger.n_clients * ledger.uplink_bits_per_client
        return self.budget_bits_per_round * (ledger.rounds + 1) - spent

    def next_fleet(self, fleet: FleetPlan,
                   ledger: Optional[BitsLedger] = None) -> FleetPlan:
        """The fleet to use for the next round(s): same cohort table and
        assignment, with every adjustable cohort's qsgd level re-picked
        from the current allowance (docstring above).  Cohort plans must
        be bound (``fleet.bind(params)``) so ``round_bits`` is
        measurable."""
        allow = self.allowance(ledger)
        adjustable = [c for c, p in enumerate(fleet.cohorts)
                      if _is_adjustable(p)]
        if not adjustable:
            return fleet

        menu = self.levels_menu
        # start every adjustable cohort at the floor
        tier = {c: 0 for c in adjustable}

        def build(c):
            return qsgd_level_plan(fleet.cohorts[c], menu[tier[c]])

        def total_bits(cohorts):
            trial = dataclasses.replace(fleet, cohorts=tuple(cohorts))
            return trial.total_round_bits()

        cohorts = list(fleet.cohorts)
        for c in adjustable:
            cohorts[c] = build(c)
        cost = total_bits(cohorts)
        # greedy water-filling: raise the lowest tier first (ties: lowest
        # cohort id); stop when no single upgrade fits the allowance
        while True:
            candidates = [c for c in adjustable if tier[c] + 1 < len(menu)]
            if not candidates:
                break
            c = min(candidates, key=lambda c: (tier[c], c))
            tier[c] += 1
            trial = list(cohorts)
            trial[c] = build(c)
            trial_cost = total_bits(trial)
            if trial_cost > allow:
                tier[c] -= 1
                break
            cohorts, cost = trial, trial_cost
        return dataclasses.replace(fleet, cohorts=tuple(cohorts))
