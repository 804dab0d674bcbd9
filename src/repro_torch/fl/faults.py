"""Deterministic fault model for the arrival-ordered async engine; the
counterpart of ``repro.fl.faults``.

A real federated fleet has stragglers, dropped payloads and clients that
go dark mid-round; the paper's probabilistic protocol has no fixed
schedule, so nothing in Algorithm 1 *requires* the lockstep rounds the
synchronous engines simulate.  :class:`FaultPlan` is the static,
validated description of a fleet's failure behaviour; every realized
fault is drawn from the SAME threefry key the protocol already uses
(DESIGN.md §11), so a faulty run is a pure function of ``(key,
FaultPlan)`` — replaying it reproduces the trajectory, the fault trace
and the ledger bit-for-bit.

Event vocabulary (per participant, per communication round):

  * **latency** — integer uplink delay in COMMUNICATION rounds, drawn
    from the categorical ``latency_probs`` (index = delay).  A payload
    sent at comm round r is scheduled to land at round ``r + delay``.
  * **drop**    — the uplink payload is lost in transit: the client
    sent it (and, under ``charge_dropped=True``, is charged for it) but
    the server never folds it.
  * **crash**   — the client is offline for the round: it neither sends
    its payload nor receives the broadcast (its aggregation update is
    masked out).  A crashed client transmits nothing, so it is never
    charged.

The server completes a round once ``quorum_count(s)`` of its s
participants have reported (arrival order = (latency, client index) —
the same index order the fused reduce folds in); later arrivals are
stragglers whose payloads land at ``r + max(latency, 1)`` with
staleness weight ``staleness_decay ** age``, and payloads that would
land more than ``max_delay`` rounds late are evicted (counted, never
folded).  See :mod:`repro_torch.core.async_engine` for the folding engine and
DESIGN.md §11 for the full semantics.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from repro_torch.core import prng

__all__ = ["FAULT_STREAM_TAG", "FaultPlan", "geometric_latency_probs",
           "fault_draws"]

#: stream tag of the fault key: ``fold_in(xi_key, 2**32 - 2)``.  The xi
#: stream folds nonnegative int32 step counters, the participation
#: stream folds 2**32 - 1 (DESIGN.md §9); 2**32 - 2 is disjoint from
#: both, so fault draws never collide with either.
FAULT_STREAM_TAG = np.uint32(2 ** 32 - 2)


def geometric_latency_probs(mean: float, max_delay: int) -> Tuple[float, ...]:
    """Truncated-geometric latency distribution with the given mean of
    the UNtruncated law: ``P[delay = a] ∝ (mean/(1+mean))^a`` for
    a = 0..max_delay, renormalized.  ``mean=0`` is the zero-latency
    point mass ``(1.0,)``."""
    if mean < 0:
        raise ValueError(f"mean latency must be >= 0, got {mean}")
    if mean == 0 or max_delay == 0:
        return (1.0,) + (0.0,) * max_delay
    r = mean / (1.0 + mean)
    raw = [r ** a for a in range(max_delay + 1)]
    z = sum(raw)
    return tuple(p / z for p in raw)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Static fault-injection configuration of one rollout.

    Attributes:
      max_delay: D — the bounded-delay buffer depth, in communication
        rounds.  A straggler payload scheduled to land more than D
        rounds after its send round is EVICTED (it would be staler than
        the buffer keeps).  ``0`` disables the staleness buffer: every
        non-fresh payload is evicted.
      latency_probs: categorical distribution of the raw uplink delay;
        index a is ``P[latency = a]``.  May extend past ``max_delay``
        (those draws evict).  Default ``(1.0,)`` = zero latency.
      drop_rate: per-participant per-round probability the uplink
        payload is lost in transit.
      crash_rate: per-participant per-round probability the client is
        offline for the round (sends nothing, receives nothing, does
        not apply the aggregation update).
      quorum: fraction of the round's participants the server waits for
        before completing the round — ``quorum_count(s) =
        clamp(round(quorum * s), 1, s)``.  ``1.0`` waits for every
        (alive) participant, which makes latency invisible: the paper's
        synchronous round.
      staleness_decay: gamma ∈ (0, 1]; a payload folded ``a`` rounds
        after its send round contributes with weight ``gamma ** a``
        (fresh payloads: gamma^0 = 1 exactly, so the zero-fault round
        is the unweighted mean bit-for-bit).
      charge_dropped: the documented ledger delivery policy (DESIGN.md
        §11).  ``True`` (default): the wire charges every payload
        actually TRANSMITTED — dropped and evicted uplinks consumed
        client bandwidth even though the server never folds them.
        ``False``: charge only payloads the server actually receives
        in time (delivered).  Crashed clients transmit nothing and are
        never charged under either policy.
    """

    max_delay: int = 0
    latency_probs: Tuple[float, ...] = (1.0,)
    drop_rate: float = 0.0
    crash_rate: float = 0.0
    quorum: float = 1.0
    staleness_decay: float = 0.5
    charge_dropped: bool = True

    def __post_init__(self):
        if int(self.max_delay) < 0:
            raise ValueError(f"max_delay must be >= 0, got {self.max_delay}")
        object.__setattr__(self, "max_delay", int(self.max_delay))
        probs = tuple(float(p) for p in self.latency_probs)
        if not probs or any(p < 0 for p in probs) \
                or not math.isclose(sum(probs), 1.0, rel_tol=1e-6):
            raise ValueError(
                f"latency_probs must be a nonempty distribution summing to "
                f"1, got {self.latency_probs}")
        object.__setattr__(self, "latency_probs", probs)
        for name in ("drop_rate", "crash_rate"):
            v = getattr(self, name)
            if not (0.0 <= float(v) <= 1.0):
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if not (0.0 < float(self.quorum) <= 1.0):
            raise ValueError(f"quorum must be in (0, 1], got {self.quorum}")
        if not (0.0 < float(self.staleness_decay) <= 1.0):
            raise ValueError(f"staleness_decay must be in (0, 1], "
                             f"got {self.staleness_decay}")

    # -- derived statics ----------------------------------------------------
    @property
    def n_slots(self) -> int:
        """Ring-buffer slot count D + 1 (slot r mod (D+1) holds the
        contributions scheduled to land at comm round r)."""
        return self.max_delay + 1

    @property
    def max_latency(self) -> int:
        """Largest drawable raw latency (static: len(latency_probs)-1)."""
        return len(self.latency_probs) - 1

    @property
    def is_null(self) -> bool:
        """True when no fault can ever fire AND the quorum waits for
        everyone — the configuration under which the async engine is
        bit-exact with the synchronous scan (the keystone invariant)."""
        return (self.drop_rate == 0.0 and self.crash_rate == 0.0
                and self.quorum == 1.0
                and all(p == 0.0 for p in self.latency_probs[1:]))

    def quorum_count(self, s: int) -> int:
        """Participants the server waits for before completing a round
        with s participants — static, like
        :func:`repro_torch.core.rollout.participant_count`."""
        return max(1, min(int(s), int(round(float(self.quorum) * int(s)))))

    def staleness_weights(self) -> np.ndarray:
        """(max_delay + 1,) f32 table of ``staleness_decay ** age`` —
        index by a payload's effective delay at fold time (age 0 is
        exactly 1.0: fresh folds are unweighted)."""
        return np.asarray(
            [self.staleness_decay ** a for a in range(self.max_delay + 1)],
            np.float32)


_TINY = np.finfo(np.float32).tiny


def _categorical(keys, logits, n: int) -> np.ndarray:
    """``jax.random.categorical(key, logits, shape=(n,))`` for a batch of
    keys (..., 2) and 1-D float32 ``logits`` (L,): the Gumbel-max trick
    of jax's default ("low") mode, in float32.  Each key draws 32-bit
    uniforms of shape (n, L) and maps them to [tiny, 1) as
    ``max(tiny, f * (1 - tiny) + tiny)`` (f the [0, 1) mantissa float,
    ``minval=tiny``); the Gumbel noise is ``-log(-log(u))``, and the draw
    is the first index of the largest ``noise + logits`` along L.
    Returns int32 (..., n)."""
    logits = np.asarray(logits, np.float32)
    bits = prng.random_bits(keys, (n, logits.shape[0]))
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)) \
        .view(np.float32) - np.float32(1.0)
    span = np.float32(1.0) - _TINY
    u = np.maximum(_TINY, floats * span + _TINY)
    gumbel = -np.log(-np.log(u))
    return np.argmax(gumbel + logits, axis=-1).astype(np.int32)


def fault_draws(xi_key, ks, n: int, plan: FaultPlan):
    """Pre-derive the per-step fault realizations for a rollout window of
    global steps ``ks`` — the protocol's FOURTH RNG stream, drawn on the
    host as the xi stream is: ``fault_key = fold_in(xi_key, 2**32 - 2)``;
    step k's draws come from ``split(fold_in(fault_key, k), 3)``
    (latency, drop, crash).  Like the xi / noise / participation streams
    the realization is a function of (key, global step) alone —
    independent of the codecs, chunk-invariant, identical on replay.

    Returns numpy ``(latency, dropped, crashed)`` of shape (len(ks), n):
    int32 raw delays and 0/1 float32 event indicators.  Steps that turn
    out not to be communication rounds simply never read their draws.
    """
    fault_key = prng.fold_in(xi_key, FAULT_STREAM_TAG)
    ks = np.asarray(ks, np.int64).reshape(-1)
    keys = prng.split(prng.fold_in(fault_key, ks), 3)      # (K, 3, 2)
    with np.errstate(divide="ignore"):
        logits = np.log(np.asarray(plan.latency_probs, np.float32))
    latency = _categorical(keys[:, 0], logits, n)
    dropped = prng.bernoulli(keys[:, 1], plan.drop_rate, (n,))
    crashed = prng.bernoulli(keys[:, 2], plan.crash_rate, (n,))
    return (latency.reshape(len(ks), n),
            dropped.astype(np.float32).reshape(len(ks), n),
            crashed.astype(np.float32).reshape(len(ks), n))
