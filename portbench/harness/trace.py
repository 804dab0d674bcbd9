"""One profiled cycle, reduced to what the per-layer readers need.

``profile(fn)`` runs ``fn(span)`` under ``torch.profiler`` (CPU and
CUDA); ``fn`` wraps each protocol step and a synchronize after it in
``span(branch)``, a ``record_function`` whose host interval names what
the host was doing while the device idled, and holds every device
operation of that step.  The reduction keeps every device operation
(kernels, copies, sets) as (name, start, seconds) and the host spans,
on the profiler's one clock.
"""
from __future__ import annotations

import dataclasses

import torch

SPAN = "portbench."
DRAWS = "int64 elementwise (threefry draws)"

#: device operations by kind, the first match of a name's words winning
CLASSES = (("codec kernels", ("qsgd_", "natural_")),
           ("gemm", ("gemm", "gemv", "xmma", "cutlass")),
           ("attention softmax", ("softmax",)),
           (DRAWS, ("<long", "long>", "int64")),
           ("reductions", ("reduce_kernel", "norm")),
           ("copies and fills", ("copy", "memcpy", "memset", "fill", "cat")),
           ("other elementwise", ("",)))


@dataclasses.dataclass
class Trace:
    ops: list           # (name, start s, seconds), device operations
    spans: list         # (branch, start s, end s), host steps
    start: float
    end: float

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (their union)."""
        busy, reach = 0.0, self.start
        for _, t0, dt in sorted(self.ops, key=lambda o: o[1]):
            t1 = min(t0 + dt, self.end)
            t0 = max(t0, reach)
            if t1 > t0:
                busy += t1 - t0
                reach = t1
        return busy

    def idle_gaps(self) -> list:
        """(branch the host was in, seconds) of every gap between device
        operations, longest first."""
        gaps, reach = [], self.start
        for _, t0, dt in sorted(self.ops, key=lambda o: o[1]):
            if t0 > reach:
                gaps.append((self.host_at(reach), t0 - reach))
            reach = max(reach, t0 + dt)
        if self.end > reach:
            gaps.append((self.host_at(reach), self.end - reach))
        return sorted(gaps, key=lambda g: -g[1])

    def host_at(self, t: float) -> str:
        for branch, t0, t1 in self.spans:
            if t0 <= t < t1:
                return f"{branch} step"
        return "between steps"

    def seconds_of(self, prefixes) -> float:
        return sum(dt for name, _, dt in self.ops
                   if any(p in name for p in prefixes))

    def by_class(self, branch: str = None) -> list:
        """(kind, seconds) of the device operations, most first; with
        ``branch``, of those that started in a step of that branch."""
        totals = {}
        for name, t0, dt in self.ops:
            if branch is not None and not any(
                    b == branch and s0 <= t0 < s1 for b, s0, s1 in self.spans):
                continue
            kind = kind_of(name)
            totals[kind] = totals.get(kind, 0.0) + dt
        return sorted(totals.items(), key=lambda kv: -kv[1])


def kind_of(name: str) -> str:
    low = name.lower()
    return next(c for c, words in CLASSES if any(w in low for w in words))


def span(branch: str):
    return torch.profiler.record_function(SPAN + branch)


def profile(fn) -> Trace:
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        fn(span)
        torch.cuda.synchronize()
    ops, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        t0 = e.start_ns() * 1e-9
        dt = e.duration_ns() * 1e-9
        if name.startswith(SPAN):
            # a span shows on the host and again on the device's timeline
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                spans.append((name[len(SPAN):], t0, t0 + dt))
        elif e.device_type() == torch.autograd.DeviceType.CUDA:
            ops.append((name, t0, dt))
    spans.sort(key=lambda s: s[1])
    if not spans:
        raise RuntimeError("the profiled cycle recorded no step spans")
    end = max([spans[-1][2]] + [t0 + dt for _, t0, dt in ops])
    return Trace(ops=ops, spans=spans, start=spans[0][1], end=end)
