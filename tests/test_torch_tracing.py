"""The port's spans and counters (``repro_torch.tracing``) on the CPU:
nothing recorded while the profiler is off, the protocol step's spans
under the right parents while it records, their host intervals on the
profiler's clock, and the counters of what a fresh round sends and
draws."""
import dataclasses
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.core import (L2GDHyper, L2GDState, flatbuf, l2gd_step,
                              make_compressor, make_plan, prng)
from repro_torch.core.collective import GATHERED
from repro_torch.data import TokenStream
from repro_torch.kernels import dispatch
from repro_torch.launch import steps
from repro_torch.launch import train as ttrain

N = 3
SHAPES = {"a": (4, 8), "b": (24,)}
HP = L2GDHyper(eta=0.3, lam=0.7, p=0.4, n=N)
CODECS = ("natural", "qsgd")
TRANSPORTS = ("leafwise", "flat")


def _quad(params, batch):
    diff = {k: params[k] - batch[k] for k in params}
    losses = sum(0.5 * (g ** 2).reshape(N, -1).sum(1) for g in diff.values())
    return losses, diff


def _problem(codec="natural", transport="leafwise"):
    gen = torch.Generator().manual_seed(0)
    params = {k: torch.randn((N,) + s, generator=gen)
              for k, s in SHAPES.items()}
    batch = {k: torch.randn((N,) + s, generator=gen)
             for k, s in SHAPES.items()}
    one = {k: torch.zeros(s) for k, s in SHAPES.items()}
    plan = make_plan(make_compressor(codec), one, transport=transport)
    state = L2GDState(params, {k: v.mean(0) for k, v in params.items()},
                      0, 0)
    return state, batch, plan


def _drive(state, batch, plan, xis=(0, 1, 1, 0)):
    for k, xi in enumerate(xis):
        state, _ = l2gd_step(state, batch, xi, prng.PRNGKey(k), _quad, HP,
                             plan, plan)
    return state


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _fresh_record():
    tracing.reset()
    yield
    tracing.reset()


def test_the_profilers_own_flag_turns_tracing_on():
    """Tracing reads the profiler's C flag, which torch.profiler sets
    while it records and clears after; a recording() block turns it on
    without the profiler."""
    assert tracing._profiler_enabled is torch._C._autograd._profiler_enabled
    assert not tracing.enabled()
    with _cpu_profile():
        assert tracing.enabled()
    assert not tracing.enabled()
    with tracing.recording():
        assert tracing.enabled()
        with tracing.recording():
            pass
        assert tracing.enabled()
    assert not tracing.enabled()


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_nothing_recorded_with_the_profiler_off(transport, monkeypatch):
    """Off, every branch runs without opening a span or making an
    event: span() hands back one shared null context."""
    def refuse(*args, **kwargs):
        raise AssertionError("a span was opened with tracing off")

    monkeypatch.setattr(tracing, "_Open", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    state, batch, plan = _problem(transport=transport)
    _drive(state, batch, plan)
    assert tracing.span("x") is tracing.span("y")
    assert tracing.spans() == []


def _children(record, parent):
    return [s.name for s in record if s.parent == parent.id]


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("transport", TRANSPORTS)
def test_step_spans_under_the_profiler(codec, transport):
    """One step.* span a call named by its branch, and the parts of each
    branch under it: grad and update; loss, average and update; loss and
    update.  The average holds the transport's parts, and the threefry
    draws lie inside the uplink and the downlink (leafwise only: the
    flat codecs draw inside their kernels)."""
    state, batch, plan = _problem(codec, transport)
    with _cpu_profile():
        _drive(state, batch, plan)
    record = tracing.spans()
    roots = [s for s in record if s.parent is None]
    assert [s.name for s in roots] == ["step.local", "step.fresh",
                                       "step.cached", "step.local"]
    assert _children(record, roots[0]) == ["grad", "update"]
    assert _children(record, roots[1]) == ["loss", "average", "update"]
    assert _children(record, roots[2]) == ["loss", "update"]
    average = next(s for s in record if s.name == "average")
    parts = _children(record, average)
    draws = [s for s in record if s.name == "draw"]
    if transport == "leafwise":
        assert parts == ["uplink"] + ["mean", "downlink"] * len(SHAPES)
        assert {s.path[:-1] for s in draws} == {
            ("step.fresh", "average", "uplink"),
            ("step.fresh", "average", "downlink")}
        assert len(draws) == 2 * len(SHAPES)
    else:
        assert parts == ["encode", "reduce", "downlink"]
        assert draws == []
    for s in record:
        assert s.device_s is None           # no events on the CPU
        assert s.start_ns <= s.end_ns


def test_step_span_lies_inside_a_record_function():
    """The spans' host clock is the profiler's: a step.* span lies inside
    the record_function range wrapped around the call."""
    state, batch, plan = _problem()
    with _cpu_profile() as prof:
        for k, xi in enumerate((0, 1)):
            with record_function(f"outer{k}"):
                state, _ = l2gd_step(state, batch, xi, prng.PRNGKey(k),
                                     _quad, HP, plan, plan)
    outer = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("outer")}
    roots = [s for s in tracing.spans() if s.parent is None]
    assert len(roots) == 2
    for k, s in enumerate(roots):
        t0, t1 = outer[f"outer{k}"]
        assert t0 <= s.start_ns <= s.end_ns <= t1


def test_a_span_on_a_thread_without_spans_takes_the_callers():
    """On a thread with no span open (autograd's device thread running a
    recompute), a span's parent is the innermost span open elsewhere."""
    seen = []

    def worker():
        with tracing.span("moe.dispatch"):
            with tracing.span("moe.router"):
                pass
        seen.append(True)

    with tracing.recording():
        with tracing.span("grad"):
            with tracing.span("inner"):
                pass
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive() and seen
    record = {s.name: s for s in tracing.spans()}
    assert record["moe.dispatch"].parent == record["grad"].id
    assert record["moe.dispatch"].thread != record["grad"].thread
    assert record["moe.router"].path == ("grad", "moe.dispatch",
                                         "moe.router")


def _moe(remat):
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                              n_layers=1, d_model=64, n_heads=2,
                              n_kv_heads=2, head_dim=32, moe_d_ff=32,
                              vocab_size=64, remat=remat)
    params = ttrain.init_stacked_params(cfg, 2, 0, "cpu")
    tokens = TokenStream(n_clients=2, vocab=64, batch=1, seq=8,
                         seed=1).batch_at(0)
    state = L2GDState(params, None, 0, 0)
    with _cpu_profile():
        l2gd_step(state, {"tokens": torch.from_numpy(tokens).long()}, 0,
                  prng.PRNGKey(0), steps.stacked_grad_fn(cfg),
                  L2GDHyper(eta=0.1, lam=0.5, p=0.2, n=2))
    return tracing.spans()


def test_remat_recompute_spans_take_the_grad_span():
    """Under remat the MoE layer's forward runs again in the backward: its
    spans, and the backward gathers', have the grad span as parent."""
    plain = _moe(remat=False)
    tracing.reset()
    record = _moe(remat=True)
    grad = next(s for s in record if s.name == "grad")
    dispatches = [s for s in record if s.name == "moe.dispatch"]
    assert len(dispatches) > sum(s.name == "moe.dispatch" for s in plain)
    for s in record:
        if s.name in ("moe.dispatch", "moe.gather_bwd"):
            assert s.parent == grad.id, s
        elif s.name in ("moe.router", "moe.experts"):
            assert s.path[:-1] == ("step.local", "grad", "moe.dispatch")
    assert any(s.name == "moe.gather_bwd" for s in record)


def _fresh_round(codec, transport):
    state, batch, plan = _problem(codec, transport)
    tracing.reset()
    l2gd_step(state, batch, 1, prng.PRNGKey(3), _quad, HP, plan, plan)
    return plan, tracing.counters()


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("transport", TRANSPORTS)
def test_wire_bits_of_a_fresh_round(codec, transport):
    """A fresh round sends n client messages and one master message, each
    the plan's round_bits(): every leaf once, none twice."""
    plan, counts = _fresh_round(codec, transport)
    assert counts["wire.up_bits"] == N * plan.round_bits()
    assert counts["wire.down_bits"] == plan.round_bits()


def _drawn(codec, shape) -> int:
    """The threefry counters one message of ``shape`` draws: natural one
    an element, QSGD one an element of its padded buckets."""
    d = int(np.prod(shape))
    if codec == "natural":
        return d
    bucket = make_compressor(codec).bucket
    return -(-d // bucket) * bucket


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("transport", TRANSPORTS)
def test_draw_elements_of_a_fresh_round(codec, transport):
    """draw.elements counts the counters the round's threefry draws hash:
    (n + 1) messages of every leaf on the leafwise transport, none on the
    flat one (its codecs draw inside the kernels)."""
    _, counts = _fresh_round(codec, transport)
    want = (N + 1) * sum(_drawn(codec, s) for s in SHAPES.values()) \
        if transport == "leafwise" else 0
    assert counts.get("draw.elements", 0) == want


def test_counters_join_one_registry():
    """The launch and gather counters are groups of the registry, the
    same objects; their own resets still work, and reset() keeps the
    bytes of the gathered tensors alive."""
    assert tracing._groups["launches"][0] is dispatch.LAUNCHES
    assert tracing._groups["gathered"][0] is GATHERED
    dispatch.LAUNCHES["probe"] += 2
    assert tracing.counters()["launches.probe"] == 2
    dispatch.reset_launches()
    assert "launches.probe" not in tracing.counters()
    live = GATHERED["live"]
    GATHERED["calls"] += 1
    tracing.reset()
    assert GATHERED["calls"] == 0 and GATHERED["live"] == live


def test_write_exports_spans_and_counters(tmp_path):
    """write() gives one Chrome-trace JSON: each span's host interval with
    its id and parent, and the counters as counter events."""
    state, batch, plan = _problem()
    with tracing.recording():
        _drive(state, batch, plan, xis=(0, 1))
    path = tmp_path / "trace.json"
    tracing.write(path)
    out = json.loads(path.read_text())
    spans = [e for e in out["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in spans] == [s.name for s in tracing.spans()]
    assert all(e["cat"] == "host" for e in spans)   # no device on the CPU
    ids = {e["args"]["id"] for e in spans}
    assert all(e["args"]["parent"] in ids | {None} for e in spans)
    counts = {e["name"]: e["args"] for e in out["traceEvents"]
              if e["ph"] == "C"}
    assert counts["wire"]["up_bits"] == N * plan.round_bits()
    assert out["otherData"]["counters"] == tracing.counters()


def test_train_cli_writes_its_trace(tmp_path):
    """--trace-out records the CLI's run and writes it at its end."""
    path = tmp_path / "run.json"
    ttrain.main(["--clients", "2", "--batch", "1", "--seq", "4",
                 "--steps", "3", "--p", "0.5", "--seed", "1",
                 "--trace-out", str(path)], device="cpu")
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e["ph"] == "X"]
    assert sum(n.startswith("step.") for n in names) == 3
    assert not tracing.enabled()


def test_flat_payload_bits_are_the_tensors_made():
    """On the flat transport the uplink counts the payload tensors the
    encoder made: their bytes times eight."""
    state, batch, plan = _problem("qsgd", "flat")
    payload = plan.encode(prng.split(prng.PRNGKey(0), N), state.params)
    made = sum(t.numel() * t.element_size() * 8
               for t in (payload.codes, payload.norms))
    assert payload.nbits == made
    assert flatbuf.supports_fused_reduce(payload)
