"""Spans and counters of the port: where a protocol step spends its time,
and what it did, read by operators and by readers of a profiled run.

A span names one part of the program (``step.fresh``, ``loss``,
``average``, ``draw``, ...) and records, while tracing is on:

  * its parent: the innermost span open on the same thread, or, on a
    thread with no span open (autograd's device thread, which runs a
    remat recompute and the custom backwards), the innermost span open on
    any other thread: the one blocked in ``backward``;
  * its host interval in nanoseconds on the profiler's clock (the Unix
    clock that ``torch.profiler``'s events carry);
  * its device seconds: a pair of CUDA events recorded on the current
    stream at entry and exit, resolved when the record is read (one
    synchronize).  None on the CPU.

Tracing is on while ``torch.profiler`` records (its own flag), and
inside a :func:`recording` block.  Off, a span costs one flag check: no
event, no allocation, no device call.  Spans are not profiler ranges,
so they add nothing to the profiler's device timeline.

:func:`spans` reads the record of closed spans, :func:`counters` the
counters, :func:`reset` clears both, :func:`write` exports them as one
Chrome-trace JSON file (``chrome://tracing``, Perfetto).

Counters are host integers, always on.  Each group is one
``collections.Counter`` made by :func:`counter`, read as
``<group>.<key>``: ``launches.<kernel>`` (``kernels.dispatch``),
``gathered.*`` and ``reduced.*`` (``core.collective``),
``draw.elements`` (the threefry counters ``core.prng`` hashed on the
device) and ``wire.up_bits`` / ``wire.down_bits`` (the payload bits of
the messages ``core.aggregation`` compressed: every client's up, the
master's down).
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import threading
import time
from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["Span", "span", "traced", "recording", "enabled", "spans",
           "counter", "counters", "reset", "write"]

#: the profiler's own flag: true while torch.profiler records
_profiler_enabled = torch._C._autograd._profiler_enabled

_depth = 0                      # open recording() blocks
_ids = itertools.count()
_record: list = []              # every span opened since the last reset
_open: dict = {}                # thread ident -> its stack of open spans
_groups: dict = {}              # counter group -> (Counter, reset)


class Span(NamedTuple):
    """One closed span as :func:`spans` gives it."""

    name: str
    id: int
    parent: Optional[int]       # the parent's id; None at the root
    path: tuple                 # the names from the root down to this one
    thread: int
    start_ns: int               # host interval, profiler clock
    end_ns: int
    device_s: Optional[float]   # CUDA events' seconds; None on the CPU


def enabled() -> bool:
    """Whether a span opened now records."""
    return _depth > 0 or _profiler_enabled()


class _Open:
    """A span while it is open, and its record until read."""

    __slots__ = ("name", "id", "parent", "path", "thread", "start_ns",
                 "end_ns", "events", "device_s")

    def __init__(self, name: str):
        thread = threading.get_ident()
        stack = _open.setdefault(thread, [])
        if stack:
            parent = stack[-1]
        else:
            # autograd's device thread: the span that called backward
            tops = [s[-1] for s in list(_open.values()) if s]
            parent = max(tops, key=lambda s: s.id) if tops else None
        self.name, self.id, self.thread = name, next(_ids), thread
        self.parent = None if parent is None else parent.id
        self.path = (name,) if parent is None else parent.path + (name,)
        self.end_ns = self.device_s = self.events = None
        stack.append(self)
        _record.append(self)
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True),
                           torch.cuda.current_device())
            self.events[0].record()
        self.start_ns = time.time_ns()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        self.end_ns = time.time_ns()
        _open[self.thread].pop()
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """``with span(name):`` records the block as a span while tracing is
    on, and costs one flag check otherwise."""
    return _Open(name) if enabled() else _OFF


def traced(name: str) -> Callable:
    """A decorator: every call of the function is a span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if enabled():
                with _Open(name):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)

        return call

    return wrap


@contextlib.contextmanager
def recording():
    """Record spans inside the block whether or not the profiler runs."""
    global _depth
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1


def spans() -> list:
    """The closed spans since the last :func:`reset`, in the order they
    opened.  Their CUDA events are resolved here, after one synchronize
    of each device they were recorded on."""
    done = [s for s in list(_record) if s.end_ns is not None]
    waiting = {s.events[2] for s in done
               if s.events is not None and s.device_s is None}
    for device in sorted(waiting):
        torch.cuda.synchronize(device)
    out = []
    for s in done:
        if s.events is not None and s.device_s is None:
            s.device_s = s.events[0].elapsed_time(s.events[1]) * 1e-3
        out.append(Span(s.name, s.id, s.parent, s.path, s.thread,
                        s.start_ns, s.end_ns, s.device_s))
    return out


def counter(group: str, reset: Callable = None) -> collections.Counter:
    """A new counter group, read as ``<group>.<key>``; ``reset`` is what
    :func:`reset` calls for it (``Counter.clear`` by default).  A module
    imported again replaces its groups."""
    c = collections.Counter()
    _groups[group] = (c, reset or c.clear)
    return c


def counters() -> dict:
    """``{"<group>.<key>": int}`` of every counter group."""
    return {f"{group}.{key}": int(value)
            for group, (c, _) in sorted(_groups.items())
            for key, value in sorted(c.items())}


def reset() -> None:
    """Clear the record of spans and reset every counter group.  Spans
    open now stay open and are not recorded."""
    _record.clear()
    for _, clear in _groups.values():
        clear()


def _device_starts(record: list) -> dict:
    """Each span's device start in ns on the host clock: on each device,
    the first span's start event is put at its host start, and the
    others at their events' distance from it."""
    first, out = {}, {}
    for s, r in record:
        if r.device_s is None:
            continue
        origin = first.setdefault(s.events[2], (s, r.start_ns))
        out[r.id] = origin[1] + round(
            origin[0].events[0].elapsed_time(s.events[0]) * 1e6)
    return out


def write(path) -> None:
    """The record and the counters as one Chrome-trace JSON file: each
    span's host interval on its thread, its device interval on its
    device's track (placed by :func:`_device_starts`), its id and
    parent in ``args``; the counters as counter events at the end."""
    record = spans()
    by_id = {s.id: s for s in _record}
    pairs = [(by_id[r.id], r) for r in record]
    device = _device_starts(pairs)
    events = []
    for s, r in pairs:
        args = {"id": r.id, "parent": r.parent}
        events.append({"name": r.name, "cat": "host", "ph": "X",
                       "pid": "host", "tid": r.thread,
                       "ts": r.start_ns / 1e3,
                       "dur": (r.end_ns - r.start_ns) / 1e3, "args": args})
        if r.id in device:
            events.append({"name": r.name, "cat": "device", "ph": "X",
                           "pid": "device", "tid": f"cuda:{s.events[2]}",
                           "ts": device[r.id] / 1e3,
                           "dur": r.device_s * 1e6, "args": args})
    end = max((r.end_ns for r in record), default=time.time_ns())
    for group, (c, _) in sorted(_groups.items()):
        events.append({"name": group, "ph": "C", "pid": "host",
                       "ts": end / 1e3,
                       "args": {k: int(v) for k, v in sorted(c.items())}})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": {"counters": counters()}}, f)
