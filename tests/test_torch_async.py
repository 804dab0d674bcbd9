"""Parity of the port's partial participation and async fault engine with
the JAX reference (DESIGN.md §9, §11), on the quadratic fixture
(tests/conftest.py) and a reduced stablelm-1.6b.

Exact: the fault draws (over 11,600 (step, client) latency draws and
their drop / crash indicators), ``FaultPlan`` and its derived statics,
the participation masks, the xi traces and branches, the (K, 8) event
tables and ``fault_totals``, the buffer's counts, the ledgers (both
replays and the drivers'), the port's own keystone (the null plan equals
the synchronous rollout in value: ``-0.0 + 0.0`` gives ``+0.0``) and
chunked == one-shot runs.

Within a stated bound, with the reason: the params against the
reference's, STEP_ULPS float32 ulps of max |w| a step — XLA contracts
the updates' multiply-adds and sums the clients in its own order (one
ulp of the operands a step, as tests/test_torch_l2gd.py states); a
compression decision that flips on an ulp would move an element by a
whole level and show here (none does at these seeds).  The reduced LM
rollout holds tests/test_torch_train.py's bounds.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from conftest import quad_grad_fn
from repro.configs import get_config as jget_config
from repro.core import L2GDHyper as JHyper
from repro.core import init_state as jinit_state
from repro.core import make_plan as jmake_plan
from repro.core import rollout as jrollout
from repro.core.async_engine import fault_totals as jfault_totals
from repro.core.async_engine import init_async_state as jinit_async
from repro.core.async_engine import rollout_l2gd_async as jasync
from repro.core.compressors import QSGD as JQSGD
from repro.core.compressors import Identity as JIdentity
from repro.core.compressors import Natural as JNatural
from repro.fl import FaultPlan as JFaultPlan
from repro.fl import fault_draws as jfault_draws
from repro.fl import geometric_latency_probs as jgeometric
from repro.fl import run_l2gd as jrun_l2gd
from repro.fl.ledger import BitsLedger as JLedger
from repro.launch import steps as jsteps
from repro.models import init_params as jinit_params
from repro_torch.configs import get_config
from repro_torch.convert import key_from_words, params_from_numpy
from repro_torch.core import (QSGD, Identity, L2GDHyper, Natural,
                              init_state, make_plan, prng, rollout_l2gd)
from repro_torch.core.async_engine import (EVENT_FIELDS, fault_totals,
                                           init_async_state,
                                           rollout_l2gd_async)
from repro_torch.core.rollout import (draw_participation_mask,
                                      participant_count, participation_masks)
from repro_torch.core.tree import tree_leaves
from repro_torch.data import TokenStream
from repro_torch.fl import (FaultPlan, fault_draws, geometric_latency_probs,
                            run_l2gd)
from repro_torch.fl.faults import FAULT_STREAM_TAG
from repro_torch.fl.ledger import BitsLedger
from repro_torch.launch import steps

STEP_ULPS = 1
N, D, STEPS = 4, 12, 24
A = np.array(jax.random.normal(jax.random.PRNGKey(7), (N, D)))
KEY = jax.random.PRNGKey(1)
TKEY = key_from_words(np.asarray(KEY))
_J1 = {"w": jax.ShapeDtypeStruct((D,), jnp.float32)}
_T1 = {"w": torch.zeros(D)}


def _codecs(name):
    """(reference (uplink, downlink), port (uplink, downlink))."""
    if name == "identity-leafwise":
        return (JIdentity(), JIdentity()), (Identity(), Identity())
    codec, transport = name.split("-")
    jc = {"qsgd": lambda: JQSGD(levels=7), "natural": JNatural}[codec]()
    tc = {"qsgd": lambda: QSGD(levels=7), "natural": Natural}[codec]()
    jup, tup = jmake_plan(jc, _J1, transport=transport), \
        make_plan(tc, _T1, transport=transport)
    if transport == "flat":
        return (jup, jmake_plan(jc, _J1, transport="flat")), \
            (tup, make_plan(tc, _T1, transport="flat"))
    return (jup, JIdentity()), (tup, Identity())


CODECS = ["qsgd-flat", "qsgd-packed", "natural-flat", "natural-packed",
          "qsgd-leafwise", "identity-leafwise"]
CHAOS = dict(max_delay=2, drop_rate=0.2, crash_rate=0.1, quorum=0.6)


def _chaos_plans(**kw):
    kw = dict(CHAOS, **kw)
    return (JFaultPlan(latency_probs=jgeometric(1.0, 4), **kw),
            FaultPlan(latency_probs=geometric_latency_probs(1.0, 4), **kw))


def _jhp(p=0.5):
    return jax.tree_util.tree_map(jnp.asarray,
                                  JHyper(eta=0.3, lam=1.0, p=p, n=N))


def _thp(p=0.5):
    return L2GDHyper(eta=0.3, lam=1.0, p=p, n=N)


def _tgrad(params, batch):
    g = params["w"] - batch
    return 0.5 * torch.sum(g ** 2, dim=1), {"w": g}


def _ref_async(jplan, codecs, part=None, steps=STEPS, xi=None):
    jc, jm = codecs
    return jasync(KEY, jinit_state({"w": jnp.zeros((N, D))}), _jhp(),
                  jnp.asarray(A), None if xi is None else jnp.asarray(xi),
                  grad_fn=quad_grad_fn, fault_plan=jplan,
                  steps=None if xi is not None else steps, client_comp=jc,
                  master_comp=jm, batch_axis=None, participation=part)


def _port_async(plan, codecs, part=None, steps=STEPS, xi=None, state=None,
                agg=None, key=TKEY):
    tc, tm = codecs
    return rollout_l2gd_async(
        key, state if state is not None else init_state(
            {"w": torch.zeros(N, D)}), _thp(), torch.from_numpy(A.copy()),
        xi, grad_fn=_tgrad, fault_plan=plan,
        steps=None if xi is not None else steps, client_comp=tc,
        master_comp=tm, batch_axis=None, participation=part, agg_state=agg)


def _within_steps(got, want, steps):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = np.spacing(np.float32(np.max(np.abs(want))))
    assert np.max(np.abs(got - want)) <= STEP_ULPS * steps * ulp


def _ledger(ledger):
    return (ledger.n_clients, ledger.uplink_bits_per_client,
            ledger.downlink_bits_per_client, ledger.rounds, ledger.history)


# --------------------------------------------------------------------------
# the fault model and the fourth stream: exact
# --------------------------------------------------------------------------

def test_fault_plan_equals_reference():
    for mean, depth in ((0.0, 3), (1.0, 3), (2.5, 6), (0.3, 0)):
        assert geometric_latency_probs(mean, depth) == \
            jgeometric(mean, depth)
    kw = dict(max_delay=3, latency_probs=jgeometric(1.0, 5), drop_rate=0.1,
              crash_rate=0.05, quorum=0.75, staleness_decay=0.7)
    ours, theirs = FaultPlan(**kw), JFaultPlan(**kw)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert (ours.n_slots, ours.max_latency, ours.is_null) == \
        (theirs.n_slots, theirs.max_latency, theirs.is_null)
    for s in range(1, 12):
        assert ours.quorum_count(s) == theirs.quorum_count(s)
    np.testing.assert_array_equal(ours.staleness_weights(),
                                  theirs.staleness_weights())
    assert FaultPlan().is_null and FaultPlan(max_delay=2).is_null
    assert not FaultPlan(quorum=0.5).is_null
    for bad in (dict(max_delay=-1), dict(latency_probs=(0.5, 0.4)),
                dict(drop_rate=1.5), dict(quorum=0.0),
                dict(staleness_decay=0.0)):
        with pytest.raises(ValueError):
            FaultPlan(**bad)
        with pytest.raises(ValueError):
            JFaultPlan(**bad)
    assert int(FAULT_STREAM_TAG) == 2 ** 32 - 2
    with pytest.raises(ValueError):
        geometric_latency_probs(-1.0, 2)


@pytest.mark.parametrize("seed,mean,depth,n,steps", [
    (0, 1.0, 3, 8, 400), (1, 2.5, 6, 16, 400), (2, 0.3, 1, 5, 400)])
def test_fault_draws_equal_reference(seed, mean, depth, n, steps):
    """The Gumbel-max latency draw (jax's categorical, "low" mode) and
    the drop / crash Bernoullis, bit for bit: 11,600 (step, client)
    latency draws over the three cases."""
    kw = dict(max_delay=depth, drop_rate=0.1, crash_rate=0.05)
    jplan = JFaultPlan(latency_probs=jgeometric(mean, depth), **kw)
    plan = FaultPlan(latency_probs=geometric_latency_probs(mean, depth), **kw)
    xi_key, _ = jax.random.split(jax.random.PRNGKey(seed))
    theirs = jfault_draws(xi_key, jnp.arange(steps, dtype=jnp.int32), n,
                          jplan)
    ours = fault_draws(key_from_words(np.asarray(xi_key)), np.arange(steps),
                       n, plan)
    for got, want in zip(ours, theirs):
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert len(np.unique(ours[0])) == depth + 1
    # chunk-invariant: a later window draws the same steps' faults
    later = fault_draws(key_from_words(np.asarray(xi_key)),
                        np.arange(100, steps), n, plan)
    for got, want in zip(later, ours):
        np.testing.assert_array_equal(got, want[100:])


@pytest.mark.parametrize("n,f", [(8, 0.75), (5, 0.5), (16, 0.3), (4, 1.0)])
def test_participation_masks_equal_reference(n, f):
    s = participant_count(n, f)
    assert s == jrollout.participant_count(n, f)
    xi_key, _ = jax.random.split(KEY)
    theirs = np.asarray(jrollout.participation_masks(
        xi_key, jnp.arange(50, dtype=jnp.int32), n, s))
    ours = participation_masks(key_from_words(np.asarray(xi_key)),
                               np.arange(50), n, s)
    np.testing.assert_array_equal(ours, theirs)
    assert ours.dtype == np.float32 and np.all(ours.sum(1) == s)
    one = draw_participation_mask(prng.PRNGKey(3), n, s)
    np.testing.assert_array_equal(one, np.asarray(
        jrollout.draw_participation_mask(jax.random.PRNGKey(3), n, s)))
    with pytest.raises(ValueError):
        participant_count(n, 0.0)


def test_ledger_replays_equal_reference():
    rng = np.random.default_rng(0)
    xis = rng.integers(0, 2, size=60)
    sent = rng.integers(0, 9, size=60)
    delivered = np.minimum(sent, rng.integers(0, 9, size=60))
    for part in (None, 0.5, 0.3, 1.0):
        ours, theirs = BitsLedger(8), JLedger(8)
        a = ours.replay_xi_trace(xis[:30], 1234.0, 567.0,
                                 participation=part)
        b = theirs.replay_xi_trace(xis[:30], 1234.0, 567.0,
                                   participation=part)
        ours.replay_xi_trace(xis[30:], 1234.0, 567.0, xi_prev=a,
                             start_step=30, participation=part)
        theirs.replay_xi_trace(xis[30:], 1234.0, 567.0, xi_prev=b,
                               start_step=30, participation=part)
        assert _ledger(ours) == _ledger(theirs)
    for charge in (True, False):
        ours, theirs = BitsLedger(8), JLedger(8)
        assert ours.replay_fault_trace(xis, sent, delivered, 999.0, 77.0,
                                       charge_dropped=charge) == \
            theirs.replay_fault_trace(xis, sent, delivered, 999.0, 77.0,
                                      charge_dropped=charge)
        assert _ledger(ours) == _ledger(theirs) and ours.rounds > 0


# --------------------------------------------------------------------------
# participation on the synchronous rollout
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["identity-leafwise", "qsgd-flat",
                                  "natural-packed", "qsgd-leafwise"])
def test_rollout_participation_matches_reference(name):
    (jc, jm), (tc, tm) = _codecs(name)
    jfinal, jtrace = jrollout.rollout_l2gd(
        KEY, jinit_state({"w": jnp.zeros((N, D))}), _jhp(), jnp.asarray(A),
        grad_fn=quad_grad_fn, steps=STEPS, client_comp=jc, master_comp=jm,
        batch_axis=None, participation=0.5)
    final, trace = rollout_l2gd(
        TKEY, init_state({"w": torch.zeros(N, D)}), _thp(),
        torch.from_numpy(A.copy()), grad_fn=_tgrad, steps=STEPS,
        client_comp=tc, master_comp=tm, batch_axis=None, participation=0.5)
    np.testing.assert_array_equal(trace.xis, np.asarray(jtrace.xis))
    np.testing.assert_array_equal(trace.branches,
                                  np.asarray(jtrace.branches))
    _within_steps(final.params["w"].numpy(), jfinal.params["w"], STEPS)
    # the sampled run differs from the full one
    full, _ = rollout_l2gd(
        TKEY, init_state({"w": torch.zeros(N, D)}), _thp(),
        torch.from_numpy(A.copy()), grad_fn=_tgrad, steps=STEPS,
        client_comp=tc, master_comp=tm, batch_axis=None)
    assert not torch.equal(full.params["w"], final.params["w"])


def test_rollout_participation_chunked_equals_one_shot():
    (_, _), (tc, tm) = _codecs("qsgd-flat")
    kw = dict(grad_fn=_tgrad, client_comp=tc, master_comp=tm,
              batch_axis=None, participation=0.5)
    batch = torch.from_numpy(A.copy())
    one, t1 = rollout_l2gd(TKEY, init_state({"w": torch.zeros(N, D)}),
                           _thp(), batch, steps=STEPS, **kw)
    st, ta = rollout_l2gd(TKEY, init_state({"w": torch.zeros(N, D)}),
                          _thp(), batch, steps=10, **kw)
    st, tb = rollout_l2gd(TKEY, st, _thp(), batch, steps=STEPS - 10, **kw)
    assert torch.equal(one.params["w"], st.params["w"])
    np.testing.assert_array_equal(t1.xis, np.concatenate([ta.xis, tb.xis]))


# --------------------------------------------------------------------------
# the async engine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", CODECS)
@pytest.mark.parametrize("part", [None, 0.5])
def test_async_chaos_matches_reference(name, part):
    jcodecs, tcodecs = _codecs(name)
    jplan, plan = _chaos_plans()
    jfinal, jagg, jtrace = _ref_async(jplan, jcodecs, part)
    final, agg, trace = _port_async(plan, tcodecs, part)
    np.testing.assert_array_equal(trace.xis, np.asarray(jtrace.xis))
    np.testing.assert_array_equal(trace.branches,
                                  np.asarray(jtrace.branches))
    np.testing.assert_array_equal(trace.events.numpy(),
                                  np.asarray(jtrace.events))
    assert fault_totals(trace) == jfault_totals(jtrace)
    assert agg.rnd == int(jagg.rnd) == trace.n_agg_comm
    np.testing.assert_array_equal(agg.buf_cnt.numpy(),
                                  np.asarray(jagg.buf_cnt))
    _within_steps(agg.buf_w.numpy(), jagg.buf_w, STEPS)
    _within_steps(final.params["w"].numpy(), jfinal.params["w"], STEPS)
    np.testing.assert_allclose(trace.losses.numpy(),
                               np.asarray(jtrace.losses), rtol=1e-5)
    tot = fault_totals(trace)
    assert tot["stale"] > 0 and tot["dropped"] > 0 and tot["crashed"] > 0


@pytest.mark.parametrize("name", CODECS)
@pytest.mark.parametrize("part", [None, 0.5])
@pytest.mark.parametrize("delay", [0, 2])
def test_null_plan_equals_sync(name, part, delay):
    """The port's keystone: zero latency, no drops or crashes, full
    quorum — the async engine is the synchronous rollout, compared by
    value (the buffer adds +0.0 to the fused accumulator)."""
    _, (tc, tm) = _codecs(name)
    null = FaultPlan(max_delay=delay, staleness_decay=0.7)
    assert null.is_null
    sync, strace = rollout_l2gd(
        TKEY, init_state({"w": torch.zeros(N, D)}), _thp(),
        torch.from_numpy(A.copy()), grad_fn=_tgrad, steps=STEPS,
        client_comp=tc, master_comp=tm, batch_axis=None, participation=part)
    final, agg, trace = _port_async(null, (tc, tm), part)
    assert torch.equal(sync.params["w"], final.params["w"])
    assert torch.equal(sync.cache["w"], final.cache["w"])
    assert torch.equal(strace.losses, trace.losses)
    np.testing.assert_array_equal(strace.xis, trace.xis)
    np.testing.assert_array_equal(strace.branches, trace.branches)
    tot = fault_totals(trace)
    assert tot["dropped"] == tot["evicted"] == tot["crashed"] == 0
    assert tot["stale"] == tot["rejected"] == 0
    assert tot["sent"] == tot["delivered"] == tot["fresh"] > 0
    assert float(agg.buf_w.sum()) == 0.0 and int(agg.buf_cnt.sum()) == 0


def test_null_plan_forced_xi():
    xi = np.asarray([1, 0, 0, 1, 1, 0, 1, 0, 0, 0, 1, 1], np.int32)
    _, (tc, tm) = _codecs("qsgd-flat")
    sync, strace = rollout_l2gd(
        TKEY, init_state({"w": torch.zeros(N, D)}), _thp(),
        torch.from_numpy(A.copy()), xi, grad_fn=_tgrad, client_comp=tc,
        master_comp=tm, batch_axis=None)
    final, _, trace = _port_async(FaultPlan(), (tc, tm), xi=xi)
    assert torch.equal(sync.params["w"], final.params["w"])
    np.testing.assert_array_equal(trace.xis, xi)


@pytest.mark.parametrize("name", ["qsgd-packed", "identity-leafwise"])
def test_async_chunked_equals_one_shot(name):
    """The fault draws and the delay buffer follow the global step and
    round clocks: two windows threading (state, agg) give the one-shot
    run bit for bit."""
    _, tcodecs = _codecs(name)
    _, plan = _chaos_plans()
    one, agg1, t1 = _port_async(plan, tcodecs, 0.75)
    st, agg, ta = _port_async(plan, tcodecs, 0.75, steps=10)
    st, agg, tb = _port_async(plan, tcodecs, 0.75, steps=STEPS - 10,
                              state=st, agg=agg)
    assert torch.equal(one.params["w"], st.params["w"])
    assert agg.rnd == agg1.rnd
    assert torch.equal(agg1.buf_w, agg.buf_w)
    for a, b in zip(tree_leaves(agg1.buf), tree_leaves(agg.buf)):
        assert torch.equal(a, b)
    assert torch.equal(t1.events, torch.cat([ta.events, tb.events]))


def test_async_reduces_only_the_scheduled_slots(monkeypatch):
    """A fresh round launches the quorum cohort's weighted reduce and one
    for each delay at which the host schedules a straggler; a delay no
    straggler lands at launches nothing (its fold would add exact zeros)."""
    from repro_torch.core import flatbuf
    from repro_torch.core.async_engine import arrival_schedule
    from repro_torch.core.rollout import window_masks
    calls = []
    real = flatbuf.reduce_payload_acc
    monkeypatch.setattr(flatbuf, "reduce_payload_acc",
                        lambda p, w: calls.append(1) or real(p, w))
    _, tcodecs = _codecs("qsgd-packed")
    _, plan = _chaos_plans()
    _, _, trace = _port_async(plan, tcodecs, 0.75)
    lats, drps, crss = fault_draws(prng.split(TKEY)[0], np.arange(STEPS), N,
                                   plan)
    masks = window_masks(TKEY, N, 0.75, 0, STEPS)
    q = plan.quorum_count(participant_count(N, 0.75))
    fresh = np.flatnonzero(trace.branches == 1)
    want = 0
    for k in fresh:
        _, _, late, eff, _ = arrival_schedule(
            np.asarray(masks[k], np.float32), lats[k], drps[k], crss[k], q,
            plan)
        want += 1 + len(set(eff[late > 0].tolist()))
    assert len(calls) == want
    assert len(fresh) < want < len(fresh) * (1 + plan.max_delay)


def test_event_conservation_and_semantics():
    _, tcodecs = _codecs("identity-leafwise")
    for plan in (_chaos_plans()[1], FaultPlan(drop_rate=0.5),
                 FaultPlan(max_delay=1, latency_probs=(0.3, 0.3, 0.4),
                           quorum=0.5, crash_rate=0.3)):
        final, _, trace = _port_async(plan, tcodecs, steps=40)
        ev = {f: trace.events.numpy()[:, i]
              for i, f in enumerate(EVENT_FIELDS)}
        np.testing.assert_array_equal(
            ev["sent"], ev["delivered"] + ev["dropped"] + ev["evicted"]
            + ev["rejected"])
        comm = trace.branches == 1
        assert (ev["sent"][~comm] == 0).all()
        np.testing.assert_array_equal(ev["sent"][comm] + ev["crashed"][comm],
                                      np.full(int(comm.sum()), N))
        assert bool(torch.isfinite(final.params["w"]).all())
    # every uplink dropped: every round empty, the cache kept, finite
    final, _, trace = _port_async(FaultPlan(drop_rate=1.0), tcodecs)
    tot = fault_totals(trace)
    assert tot["delivered"] == 0 and tot["dropped"] == tot["sent"] > 0
    assert torch.equal(final.cache["w"], torch.zeros(D))   # init's mean
    assert bool(torch.isfinite(final.params["w"]).all())


def test_async_rejects_non_finite_payloads():
    _, (tc, tm) = _codecs("qsgd-flat")
    _, plan = _chaos_plans(crash_rate=0.0, drop_rate=0.0)
    batch = torch.from_numpy(A.copy())
    batch[2, 3] = float("nan")      # client 2's gradient and model go NaN
    final, _, trace = rollout_l2gd_async(
        TKEY, init_state({"w": torch.zeros(N, D)}), _thp(), batch,
        grad_fn=_tgrad, fault_plan=plan, steps=STEPS, client_comp=tc,
        master_comp=tm, batch_axis=None)
    assert fault_totals(trace)["rejected"] > 0
    for i in (0, 1, 3):
        assert bool(torch.isfinite(final.params["w"][i]).all())


def test_fleet_uplinks_raise():
    class Fleet:
        cohorts = ()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_async_state({"w": torch.zeros(N, D)}, Fleet(), FaultPlan())


# --------------------------------------------------------------------------
# the driver
# --------------------------------------------------------------------------

def _drivers(steps=30, **kw):
    jrun = jrun_l2gd(KEY, {"w": jnp.zeros((N, D))}, quad_grad_fn, _jhp(),
                     lambda k: jnp.asarray(A), steps, **kw.get("j", {}))
    trun = run_l2gd(TKEY, {"w": torch.zeros(N, D)}, _tgrad, _thp(),
                    lambda k: torch.from_numpy(A.copy()), steps, device="cpu",
                    **kw.get("t", {}))
    return trun, jrun


@pytest.mark.parametrize("mode", ["scan", "host"])
def test_driver_participation_matches_reference(mode):
    (jc, jm), (tc, tm) = _codecs("qsgd-flat")
    trun, jrun = _drivers(
        j=dict(client_comp=JQSGD(levels=7), master_comp=JQSGD(levels=7),
               participation=0.5, mode=mode, chunk=7),
        t=dict(client_comp=QSGD(levels=7), master_comp=QSGD(levels=7),
               participation=0.5, mode=mode, chunk=7))
    assert _ledger(trun.ledger) == _ledger(jrun.ledger)
    full = make_plan(QSGD(levels=7), _T1).round_bits()
    assert trun.ledger.uplink_bits_per_client == \
        trun.ledger.rounds * full / 2
    np.testing.assert_array_equal(trun.xis, jrun.xis)
    assert (trun.n_local, trun.n_agg_comm, trun.n_agg_cached) == \
        (jrun.n_local, jrun.n_agg_comm, jrun.n_agg_cached)
    _within_steps(trun.state.params["w"].numpy(), jrun.state.params["w"], 30)


@pytest.mark.parametrize("charge", [True, False])
def test_driver_faults_match_reference(charge):
    jplan, plan = _chaos_plans(charge_dropped=charge)
    trun, jrun = _drivers(
        j=dict(client_comp=jmake_plan(JNatural(), _J1, transport="packed"),
               faults=jplan, participation=0.75, chunk=9),
        t=dict(client_comp=make_plan(Natural(), _T1, transport="packed"),
               faults=plan, participation=0.75, chunk=9))
    assert trun.fault_stats == jrun.fault_stats
    assert _ledger(trun.ledger) == _ledger(jrun.ledger)
    np.testing.assert_array_equal(trun.xis, jrun.xis)
    _within_steps(trun.state.params["w"].numpy(), jrun.state.params["w"], 30)
    # the null plan: faults=FaultPlan() equals faults=None in value
    null, _ = _drivers(t=dict(faults=FaultPlan(), chunk=9))
    sync, _ = _drivers(t=dict(chunk=9))
    assert torch.equal(null.state.params["w"], sync.state.params["w"])
    assert _ledger(null.ledger) == _ledger(sync.ledger)
    assert sync.fault_stats is None and null.fault_stats["sent"] > 0


def test_driver_fault_guards():
    for bad in (dict(faults=FaultPlan(), mode="host"),
                dict(faults=FaultPlan(), local_steps=2)):
        with pytest.raises(ValueError):
            run_l2gd(TKEY, {"w": torch.zeros(N, D)}, _tgrad, _thp(),
                     lambda k: torch.from_numpy(A.copy()), 4, device="cpu", **bad)


# --------------------------------------------------------------------------
# the LM face: build_async_rollout_fn on a reduced stablelm-1.6b
# --------------------------------------------------------------------------

def test_build_async_rollout_fn_matches_reference():
    """Reduced stablelm-1.6b (2 layers, d_model 256, vocab 512), 2
    clients, the reference's weights carried across, leafwise natural
    both ways under a chaos plan: protocol and events exact, params and
    losses within tests/test_torch_train.py's bounds."""
    cfg = get_config("stablelm-1.6b").reduced()
    jcfg = jget_config("stablelm-1.6b").reduced()
    n, length = 2, 6
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    jp = jax.vmap(lambda k: jinit_params(k, jcfg))(keys)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    tokens = np.stack([TokenStream(n_clients=n, vocab=512, batch=2, seq=16,
                                   seed=1).batch_at(k)
                       for k in range(length)])
    kw = dict(max_delay=1, latency_probs=(0.5, 0.5), drop_rate=0.2,
              quorum=0.5)
    jhp = JHyper(eta=jnp.asarray(0.1, jnp.float32),
                 lam=jnp.asarray(0.5, jnp.float32),
                 p=jnp.asarray(0.5, jnp.float32), n=n)
    hp = L2GDHyper(eta=0.1, lam=0.5, p=0.5, n=n)
    jroll = jsteps.build_async_rollout_fn(
        jcfg, jhp, JFaultPlan(**kw), JNatural(), JNatural(), length=length,
        donate=False)
    troll = steps.build_async_rollout_fn(cfg, hp, FaultPlan(**kw), Natural(),
                                         Natural(), length=length)
    key = jax.random.PRNGKey(11)
    jstate = jinit_state(jp)
    jfinal, _, jtrace = jroll(
        jstate, jinit_async(jp, jmake_plan(JNatural(),
                                           jsteps.param_shapes(jcfg),
                                           transport="leafwise"),
                            JFaultPlan(**kw)),
        {"tokens": jnp.asarray(tokens)}, jax.random.key_data(key))
    state = init_state(tp)
    up = make_plan(Natural(), steps.param_shapes(cfg), transport="leafwise")
    final, agg, trace = troll(state, init_async_state(tp, up,
                                                      FaultPlan(**kw)),
                              {"tokens": torch.from_numpy(tokens)},
                              np.asarray(key))
    np.testing.assert_array_equal(trace.xis, np.asarray(jtrace.xis))
    np.testing.assert_array_equal(trace.events.numpy(),
                                  np.asarray(jtrace.events))
    assert trace.n_agg_comm >= 1
    np.testing.assert_allclose(trace.losses.numpy(),
                               np.asarray(jtrace.losses), rtol=1e-5)
    for got, want in zip(tree_leaves(final.params),
                         jax.tree.leaves(jfinal.params)):
        want = np.asarray(want)
        assert np.max(np.abs(got.numpy() - want)) <= \
            1e-5 * max(float(np.max(np.abs(want))), 1e-30)
