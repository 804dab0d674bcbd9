"""The numbers that decide ``correct``, each against its limit.

The prologue (the three steps that set-up drives):
  loss_gap    the widest relative gap of a prologue step's loss
  grad_gap    the worst (client, leaf) gap between the program's and the
              reference's norm of the first gradient, over the larger of
              that leaf's reference norm and the median leaf's
  change_gap  the same for the norm of each leaf's change after the
              prologue, leaving out leaves whose reference gradient is
              under a thousandth of the median leaf's (they move under
              round-off alone)

The timed window, which the reference follows step by step:
  window_loss_gap    the widest relative gap of a window step's loss
  window_change_gap  the change gap of each leaf after the window
  target_gap  the worst leaf's norm of the difference between the
              program's and the reference's cached target after the
              window (its last fresh round's compressed average), over
              the larger of that leaf's reference norm and the median
              leaf's: a noise drawn with the wrong key, or a target
              kept from an earlier round, has the law of the right one
              and leaves the norms as they were
  bits_gap    the window's bits ledger, from the rounds the program's
              steps report, against the wire bits the reference counts
              from the shapes and its own rounds: exact

``<number>_median`` is the median (client, leaf)'s gap in place of the
worst, where the worst swings from seed to seed (a route that flips on
a near tie moves a few leaves of a mixture of experts).

A cell compares the numbers its ``limits`` name.  A number that is not
finite fails its limit.
"""
from __future__ import annotations

import math

import numpy as np
import torch

NAMES = ("loss_gap", "grad_gap", "change_gap", "grad_gap_median",
         "change_gap_median", "window_loss_gap", "window_change_gap",
         "window_change_gap_median", "target_gap", "target_gap_median",
         "bits_gap")
STILL = 1e-3


def leaf_gaps(program: np.ndarray, reference: np.ndarray,
              keep: np.ndarray = None) -> np.ndarray:
    """Each kept (client, leaf)'s relative gap of norms."""
    keep = np.ones(reference.shape, bool) if keep is None else keep
    ref, got = reference[keep], program[keep]
    return np.abs(got - ref) / np.maximum(ref, np.median(ref))


def target_norms(program: dict, reference: dict) -> np.ndarray:
    """(2, leaves): each leaf's norm of the difference of the two cached
    targets ({name: tensor}, the program's may be on the host) and the
    reference's norm, in float64."""
    out = np.zeros((2, len(reference)))
    for j, name in enumerate(sorted(reference)):
        ref = reference[name]
        got = program[name].to(ref.device)
        out[0, j] = float(torch.linalg.vector_norm(
            (got - ref).reshape(-1), dtype=torch.float64))
        out[1, j] = float(torch.linalg.vector_norm(
            ref.reshape(-1), dtype=torch.float64))
        del got
    return out


def as_program(out: dict, prologue: int) -> dict:
    """A reference's run in the program's shape: the prologue's losses
    apart from the window's."""
    return {**out, "losses": out["losses"][:prologue],
            "window_losses": out["losses"][prologue:]}


def _loss_gap(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref) / np.abs(ref)))


def gaps(program: dict, reference: dict) -> dict:
    """Every number but ``bits_gap``: ``program`` in the program's shape
    (see ``as_program``), ``reference`` as ``l2gd.follow`` returns it."""
    prologue = len(program["losses"])
    g_ref = reference["grad_norms"]
    moving = g_ref >= STILL * np.median(g_ref)
    grad = leaf_gaps(program["grad_norms"], g_ref)
    change = leaf_gaps(program["change_norms"], reference["change_norms"],
                       moving)
    window = leaf_gaps(program["window_change_norms"],
                       reference["window_change_norms"], moving)
    diff, norm = target_norms(program["cache"], reference["cache"])
    target = diff / np.maximum(norm, np.median(norm))
    return {"loss_gap": _loss_gap(program["losses"],
                                  reference["losses"][:prologue]),
            "grad_gap": float(np.max(grad)),
            "change_gap": float(np.max(change)),
            "grad_gap_median": float(np.median(grad)),
            "change_gap_median": float(np.median(change)),
            "window_loss_gap": _loss_gap(program["window_losses"],
                                         reference["losses"][prologue:]),
            "window_change_gap": float(np.max(window)),
            "window_change_gap_median": float(np.median(window)),
            "target_gap": float(np.max(target)),
            "target_gap_median": float(np.median(target))}


def checks(program: dict, reference: dict, bits: float, bits_ref: float,
           limits: dict) -> dict:
    values = {**gaps(program, reference), "bits_gap": abs(bits - bits_ref)}
    return {k: {"value": values[k], "limit": limits[k]} for k in NAMES
            if k in limits}


def correct(checked: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checked.values())
