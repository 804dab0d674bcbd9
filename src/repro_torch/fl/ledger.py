"""bits/n accounting — the paper's Table II metric; the counterpart of
``repro.fl.ledger`` (copied, not imported: importing ``repro.fl`` would
load jax).

Per communication round the ledger charges

  * uplink:   each client sends its payload -> nbits(uplink payload)
              per client
  * downlink: the master broadcasts to all n clients -> nbits(downlink
              payload) per client

where both numbers are ``CompressionPlan.round_bits()`` (DESIGN.md §3).
A round happens exactly on each local->aggregation transition
(xi_k = 1, xi_{k-1} = 0); :meth:`BitsLedger.replay_xi_trace` rebuilds the
ledger from a realized xi trace, bit for bit the one a per-step loop
records.

Partial participation (DESIGN.md §9): a round that samples s =
``participant_count(n, f)`` clients sends s uplinks and s broadcasts, so
it costs s/n of a full round per client on both directions.  The async
fault engine's rounds (DESIGN.md §11) are charged from their realized
delivery counts by :meth:`BitsLedger.replay_fault_trace`.
"""
from __future__ import annotations

import dataclasses
from typing import List

__all__ = ["BitsLedger", "per_client_uplink"]


def per_client_uplink(bits: float, n_clients: int) -> float:
    """The per-client uplink charge of a uniform plan.  Per-client cost
    vectors (heterogeneous fleets) are a later slice of the port."""
    if not isinstance(bits, (int, float)):
        raise NotImplementedError("per-client uplink vectors (fleets) are "
                                  "not ported yet; see ROADMAP.md")
    return float(bits)


@dataclasses.dataclass
class BitsLedger:
    n_clients: int
    uplink_bits_per_client: float = 0.0
    downlink_bits_per_client: float = 0.0
    rounds: int = 0
    history: List[dict] = dataclasses.field(default_factory=list)

    @property
    def bits_per_client(self) -> float:
        return self.uplink_bits_per_client + self.downlink_bits_per_client

    def record_round(self, uplink_bits_one_client: float,
                     downlink_bits: float, step: int | None = None) -> None:
        self.uplink_bits_per_client += uplink_bits_one_client
        self.downlink_bits_per_client += downlink_bits
        self.rounds += 1
        self.history.append({
            "step": step, "round": self.rounds,
            "bits_per_client": self.bits_per_client,
        })

    def replay_xi_trace(self, xis, uplink_bits_one_client: float,
                        downlink_bits: float, *, xi_prev: int = 1,
                        start_step: int = 0,
                        participation: float | None = None) -> int:
        """Charge one round on each local->aggregation transition of the
        trace; ``xi_prev`` defaults to Algorithm 1's input xi_{-1} = 1 and
        ``start_step`` offsets the recorded steps, so chunked replays
        concatenate into one history.  ``participation`` (optional
        fraction f) charges each sampled round at s/n of a full round on
        both directions, s = ``participant_count(n_clients, f)``.
        Returns the trace's last xi."""
        up_bits = per_client_uplink(uplink_bits_one_client, self.n_clients)
        scale = 1.0
        if participation is not None:
            from repro_torch.core.rollout import participant_count
            scale = participant_count(self.n_clients,
                                      participation) / self.n_clients
        for i, xi in enumerate(int(x) for x in xis):
            if xi == 1 and xi_prev == 0:
                self.record_round(scale * up_bits, scale * downlink_bits,
                                  step=start_step + i)
            xi_prev = xi
        return xi_prev

    def replay_fault_trace(self, xis, sent, delivered,
                           uplink_bits_one_client: float,
                           downlink_bits: float, *, xi_prev: int = 1,
                           start_step: int = 0,
                           charge_dropped: bool = True) -> int:
        """Replay an async fault trace (:mod:`repro_torch.core.
        async_engine`) into the ledger — the delivery-charging policy of
        DESIGN.md §11.  ``sent`` / ``delivered`` are the per-step event
        counts (``AsyncRolloutTrace.events`` columns 0 and 1).  Rounds
        happen on local->aggregation transitions as in
        :meth:`replay_xi_trace`; a round costs

          * uplink:   (sent/n) * round_bits under ``charge_dropped=True``
            (dropped and evicted payloads used the clients' bandwidth),
            (delivered/n) under ``False``;
          * downlink: (sent/n) * round_bits (every alive participant
            receives the broadcast; crashed clients are never charged).

        With no faults this is :meth:`replay_xi_trace` bit for bit.
        Returns the final xi."""
        n = self.n_clients
        up_bits = per_client_uplink(uplink_bits_one_client, n)
        for i, xi in enumerate(int(x) for x in xis):
            if xi == 1 and xi_prev == 0:
                up_count = int(sent[i]) if charge_dropped \
                    else int(delivered[i])
                self.record_round(
                    (up_count / n) * up_bits,
                    (int(sent[i]) / n) * downlink_bits,
                    step=start_step + i)
            xi_prev = xi
        return xi_prev
