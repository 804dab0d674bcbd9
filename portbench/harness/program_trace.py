"""The program's own spans (``repro_torch.tracing``), for the readers of
the metrics that time the parts of a protocol step.

The program records its spans while ``torch.profiler`` records, so once
``cell.run`` has returned the record holds the profiled cycle alone.  A
program without the tracing module has no record, and the readers read
nothing there.
"""
from __future__ import annotations


def record():
    """The program's closed spans, or None where it records none."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.spans() or None


def count(record, *names) -> int:
    return sum(1 for s in record if s.name in names)


def device_seconds(record, name: str, inside: str = None):
    """Device seconds of the spans ``name`` (those not inside another
    ``name``), with ``inside`` among their ancestors where given; None
    where there are none or their device seconds were not taken."""
    picked = [s for s in record if s.name == name
              and name not in s.path[:-1]
              and (inside is None or inside in s.path[:-1])]
    if not picked or any(s.device_s is None for s in picked):
        return None
    return sum(s.device_s for s in picked)


def idle_gaps(trace) -> list:
    """(start, end) in seconds of every gap between the trace's device
    operations, from its start to its end."""
    gaps, reach = [], trace.start
    for _, t0, dt in sorted(trace.ops, key=lambda o: o[1]):
        if t0 > reach:
            gaps.append((reach, min(t0, trace.end)))
        reach = max(reach, t0 + dt)
    if trace.end > reach:
        gaps.append((reach, trace.end))
    return gaps


def overlap_s(intervals, others) -> float:
    """Seconds that the (start, end) ``intervals`` share with ``others``
    (neither list overlapping itself)."""
    return sum(max(0.0, min(a1, b1) - max(a0, b0))
               for a0, a1 in intervals for b0, b1 in others)
