"""The readers of the program's spans on a made-up record and trace:
hand counts of each metric, None without a trace, without a record, or
where the spans they read are missing."""
import pytest

from portbench.harness import program_trace, spec
from portbench.harness.cell import Run
from portbench.harness.trace import Trace
from portbench.tests.tiny import one_thread  # noqa: F401
from repro_torch import tracing

METRICS = ("agg_loss_s", "average_s", "threefry_s", "program_idle_share")
NS = 10 ** 9


def _span(name, i, parent, path, t0, t1, device_s):
    return tracing.Span(name, i, parent, path, 1, int(t0 * NS),
                        int(t1 * NS), device_s)


def _record(draws=True):
    """A local, a fresh and a cached step: the fresh round's average
    holds two draws (leafwise) or none (flat)."""
    fresh = ("step.fresh",)
    out = [_span("step.local", 0, None, ("step.local",), 10.0, 12.0, 1.9),
           _span("grad", 1, 0, ("step.local", "grad"), 10.1, 11.5, 1.4),
           _span("step.fresh", 2, None, fresh, 12.5, 14.8, 2.4),
           _span("loss", 3, 2, fresh + ("loss",), 12.5, 13.0, 0.5),
           _span("average", 4, 2, fresh + ("average",), 13.0, 14.5, 1.5)]
    if draws:
        up = fresh + ("average", "uplink")
        out += [_span("uplink", 5, 4, up, 13.0, 14.0, 1.0),
                _span("draw", 6, 5, up + ("draw",), 13.0, 13.6, 0.6),
                _span("draw", 7, 5, up + ("draw",), 13.6, 13.9, 0.25)]
    out += [_span("step.cached", 8, None, ("step.cached",), 15.5, 16.0, 0.4),
            _span("loss", 9, 8, ("step.cached", "loss"), 15.5, 15.8, 0.3)]
    return out


def _trace():
    # the device idles 11.0-11.5 (inside step.local) and 14.0-15.0
    # (inside step.fresh up to 14.8) of the window 10.0-16.0
    ops = [("gemm", 10.0, 1.0), ("gemm", 11.5, 2.5), ("copy", 15.0, 1.0)]
    spans = [("local", 10.0, 12.25), ("fresh", 12.25, 15.25),
             ("cached", 15.25, 16.0)]
    return Trace(ops=ops, spans=spans, start=10.0, end=16.0)


def _run(transport="leafwise", trace=True):
    return Run(cell={"transport": transport}, config={}, shapes={},
               setup_s=1.0, window_s=1.0, branches=[0, 1, 2],
               step_seconds=[], peak_bytes=0,
               trace=_trace() if trace else None,
               trace_fresh_rounds=1 if trace else 0)


def _read(run):
    return {m: spec.reader(m)(run) for m in METRICS}


def test_readers_on_a_record(monkeypatch):
    monkeypatch.setattr(tracing, "spans", _record)
    read = _read(_run())
    assert read["agg_loss_s"] == pytest.approx((0.5 + 0.3) / 2)
    assert read["average_s"] == pytest.approx(1.5)
    assert read["threefry_s"] == pytest.approx(0.85)
    assert read["program_idle_share"] == pytest.approx(100 * 1.3 / 6.0)
    assert read["program_idle_share"] <= spec.reader("idle_share")(_run())


def test_readers_read_nothing_without_a_trace(monkeypatch):
    monkeypatch.setattr(tracing, "spans", _record)
    assert _read(_run(trace=False)) == dict.fromkeys(METRICS)


def test_readers_read_nothing_without_a_record(monkeypatch):
    monkeypatch.setattr(tracing, "spans", list)
    assert _read(_run()) == dict.fromkeys(METRICS)


def test_threefry_s_reads_nothing_on_the_flat_cell(monkeypatch):
    monkeypatch.setattr(tracing, "spans", lambda: _record(draws=False))
    read = _read(_run("flat"))
    assert read["threefry_s"] is None
    assert read["average_s"] == pytest.approx(1.5)


def test_device_seconds_need_every_event(monkeypatch):
    """Spans recorded without device events (the CPU) give no number."""
    cpu = [s._replace(device_s=None) for s in _record()]
    monkeypatch.setattr(tracing, "spans", lambda: cpu)
    read = _read(_run())
    assert read["agg_loss_s"] is None and read["threefry_s"] is None
    # the idle share reads host intervals only
    assert read["program_idle_share"] == pytest.approx(100 * 1.3 / 6.0)


def test_idle_gaps_and_overlap():
    assert program_trace.idle_gaps(_trace()) == [(11.0, 11.5),
                                                 (14.0, 15.0)]
    assert program_trace.overlap_s([(0.0, 2.0), (3.0, 4.0)],
                                   [(1.0, 3.5)]) == pytest.approx(1.5)
