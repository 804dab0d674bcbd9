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
                        start_step: int = 0) -> int:
        """Charge one round on each local->aggregation transition of the
        trace; ``xi_prev`` defaults to Algorithm 1's input xi_{-1} = 1 and
        ``start_step`` offsets the recorded steps, so chunked replays
        concatenate into one history.  Returns the trace's last xi."""
        up_bits = per_client_uplink(uplink_bits_one_client, self.n_clients)
        for i, xi in enumerate(int(x) for x in xis):
            if xi == 1 and xi_prev == 0:
                self.record_round(up_bits, downlink_bits,
                                  step=start_step + i)
            xi_prev = xi
        return xi_prev
