"""Serving metrics: per-tenant latency and throughput — the counterpart
of ``repro.serve.metrics`` (copied, not imported: importing
``repro.serve`` would load jax).

Two latency numbers per request, host clocks around work that ends in a
device synchronization:

  TTFT      — the batch's prefill (the prompt teacher-forced through the
              decode steps; the first generated token is on the device
              when it ends);
  tokens/s  — generated tokens over (prefill + decode) time.

Cache counters follow the engine's LRU: a hit is a tenant whose
materialized params were resident, a miss decodes the tenant on demand
through the unpack kernels, an eviction names the tenant dropped
(deterministic: least-recently-used first, insertion order breaking
ties by construction of ``OrderedDict``)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

__all__ = ["TenantStats", "ServeMetrics"]


@dataclasses.dataclass
class TenantStats:
    """Rolling per-tenant serving counters."""

    requests: int = 0
    tokens_generated: int = 0
    hits: int = 0
    misses: int = 0
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    gen_time_s: float = 0.0

    @property
    def mean_ttft_s(self) -> float:
        return sum(self.ttft_s) / len(self.ttft_s) if self.ttft_s else 0.0

    @property
    def tokens_per_s(self) -> float:
        return (self.tokens_generated / self.gen_time_s
                if self.gen_time_s > 0 else 0.0)


@dataclasses.dataclass
class ServeMetrics:
    """Engine-level metrics: per-tenant stats + global cache counters."""

    tenants: Dict[str, TenantStats] = dataclasses.field(default_factory=dict)
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    eviction_log: List[str] = dataclasses.field(default_factory=list)
    batches: int = 0

    def tenant(self, tid) -> TenantStats:
        return self.tenants.setdefault(str(tid), TenantStats())

    def record_hit(self, tid) -> None:
        self.hits += 1
        self.tenant(tid).hits += 1

    def record_miss(self, tid) -> None:
        self.misses += 1
        self.tenant(tid).misses += 1

    def record_eviction(self, tid) -> None:
        self.evictions += 1
        self.eviction_log.append(str(tid))

    def snapshot(self) -> dict:
        """Plain-dict view for CLIs / benchmark rows."""
        return {
            "hits": self.hits, "misses": self.misses,
            "evictions": self.evictions, "batches": self.batches,
            "tenants": {
                tid: {"requests": s.requests,
                      "tokens_generated": s.tokens_generated,
                      "hits": s.hits, "misses": s.misses,
                      "mean_ttft_s": s.mean_ttft_s,
                      "tokens_per_s": s.tokens_per_s}
                for tid, s in self.tenants.items()},
        }
