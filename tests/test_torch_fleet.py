"""Parity of the port's heterogeneous fleets and bandwidth-budget
controller with the JAX reference (DESIGN.md §13), on the quadratic
fixture (tests/conftest.py): the counterparts of tests/test_fleet.py's
API, keystone, mixed-mean, key-schedule, ledger and controller tests.

Exact: the FleetPlan surface (labels, mixes, per-client bits), the
uniform-fleet keystone (a uniform fleet unwraps to its plan, so every
engine runs the single-plan code: ``torch.equal``), the ledgers (bit for
bit the reference's, and conserved: R rounds charge R * sum_i bits_i),
xi traces, event tables and the controller's level schedule.

Within a stated bound: a mixed fleet's mean and runs against the
reference's, MEAN_ULPS float32 ulps of max |x| a round — the cohorts'
codecs are the single-plan codecs the port already holds to the
reference bit for bit given the same inputs, and the float32 sums of
the clients and cohorts may associate in another order (one rounding a
client).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_threads import torch_one_thread  # noqa: F401
from conftest import quad_grad_fn
from repro.core import L2GDHyper as JHyper
from repro.core import init_state as jinit_state
from repro.core import make_plan as jmake_plan
from repro.core import rollout as jrollout
from repro.core.async_engine import rollout_l2gd_async as jasync
from repro.core.compressors import Identity as JIdentity
from repro.core.compressors import make_compressor as jmake_compressor
from repro.fl import FaultPlan as JFaultPlan
from repro.fl import geometric_latency_probs as jgeometric
from repro.fl import run_l2gd as jrun_l2gd
from repro.fl.controller import BandwidthBudgetController as JController
from repro.fl.fleet import FleetPlan as JFleetPlan
from repro.fl.fleet import fleet_mean as jfleet_mean
from repro.fl.ledger import BitsLedger as JLedger
from repro_torch.configs import get_config
from repro_torch.convert import key_from_words
from repro_torch.core import (Identity, L2GDHyper, as_plan,
                              compressed_average, init_state,
                              make_compressor, make_plan, prng,
                              rollout_l2gd)
from repro_torch.core.async_engine import (init_async_state,
                                           rollout_l2gd_async)
from repro_torch.core.rollout import participant_count
from repro_torch.fl import (BandwidthBudgetController, FaultPlan,
                            FleetPlan, as_fleet_plan, cohort_label,
                            fleet_from_plans, fleet_mean,
                            geometric_latency_probs, qsgd_level_plan,
                            resolve_uplink, run_l2gd)
from repro_torch.fl.ledger import BitsLedger, per_client_uplink
from repro_torch.launch import steps

MEAN_ULPS = 2
N, D = 4, 12
A = np.array(jax.random.normal(jax.random.PRNGKey(7), (N, D)))
ONE = {"w": torch.zeros(D)}
J1 = {"w": jax.ShapeDtypeStruct((D,), jnp.float32)}
MIX = (0, 1, 2, 2)


def _hp(p=0.5):
    return L2GDHyper(eta=0.3, lam=1.0, p=p, n=N)


def _jhp(p=0.5):
    return jax.tree_util.tree_map(jnp.asarray,
                                  JHyper(eta=0.3, lam=1.0, p=p, n=N))


def _grad(params, batch):
    g = params["w"] - batch
    return 0.5 * torch.sum(g ** 2, dim=1), {"w": g}


def _zero():
    return {"w": torch.zeros(N, D)}


def _batch():
    return torch.from_numpy(A.copy())


def _mixed_fleet(assignment=MIX, params=ONE):
    """The canonical 3-cohort mix: identity-leafwise / natural-flat /
    narrow qsgd4-packed (benchmarks/bench_fleet.py's)."""
    return FleetPlan(cohorts=(
        make_plan(Identity(), params, transport="leafwise"),
        make_plan(make_compressor("natural"), params, transport="flat"),
        make_plan(make_compressor("qsgd", levels=4), params,
                  transport="packed", narrow=True)), assignment=assignment)


def _jmixed_fleet(assignment=MIX):
    return JFleetPlan(cohorts=(
        jmake_plan(JIdentity(), J1, transport="leafwise"),
        jmake_plan(jmake_compressor("natural"), J1, transport="flat"),
        jmake_plan(jmake_compressor("qsgd", levels=4), J1,
                   transport="packed", narrow=True)), assignment=assignment)


def _within(got, want, rounds=1):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = np.spacing(np.float32(max(np.max(np.abs(want)), 1e-30)))
    assert np.max(np.abs(got - want)) <= MEAN_ULPS * max(rounds, 1) * ulp


def _ledger(ledger):
    return (ledger.n_clients, ledger.uplink_bits_per_client,
            ledger.downlink_bits_per_client, ledger.rounds, ledger.history)


# --------------------------------------------------------------------------
# the FleetPlan surface
# --------------------------------------------------------------------------

def test_fleet_plan_api_equals_reference():
    fleet, jfleet = _mixed_fleet(), _jmixed_fleet()
    assert fleet.n_clients == N and fleet.n_cohorts == 3
    assert fleet.used_cohorts == jfleet.used_cohorts == (0, 1, 2)
    assert not fleet.is_uniform
    assert fleet.cohort_of(3) == 2
    assert fleet.plan_for(1) is fleet.cohorts[1]
    assert fleet.clients_of(2) == (2, 3)
    assert fleet.mix == jfleet.mix == "identity-natural-qsgd4n"
    vec = fleet.round_bits_vector()
    assert vec == jfleet.round_bits_vector()
    assert vec[2] == vec[3] == fleet.round_bits(2)
    assert fleet.total_round_bits() == jfleet.total_round_bits() == sum(vec)
    with pytest.raises(ValueError, match="no single uniform plan"):
        fleet.uniform_plan


def test_fleet_plan_validation():
    plan = make_plan(Identity(), ONE)
    with pytest.raises(ValueError, match="at least one cohort"):
        FleetPlan(cohorts=(), assignment=())
    with pytest.raises(TypeError, match="not a CompressionPlan"):
        FleetPlan(cohorts=(Identity(),), assignment=(0,))
    with pytest.raises(ValueError, match="assigned to cohort"):
        FleetPlan(cohorts=(plan,), assignment=(0, 1))
    with pytest.raises(ValueError, match="names for"):
        FleetPlan(cohorts=(plan,), assignment=(0,), names=("a", "b"))
    assert FleetPlan(cohorts=(plan,), assignment=(0,),
                     names=("phones",)).mix == "phones"


def test_as_fleet_plan_and_resolve():
    plan = make_plan(make_compressor("qsgd"), ONE, transport="flat")
    fleet = as_fleet_plan(plan, N)
    assert fleet.is_uniform and fleet.n_clients == N
    # the keystone unwrap is structural: the very same plan object
    assert resolve_uplink(fleet) is plan
    assert as_fleet_plan(fleet, N) is fleet
    with pytest.raises(ValueError, match="covers"):
        as_fleet_plan(fleet, N + 1)
    mixed = _mixed_fleet()
    assert resolve_uplink(mixed) is mixed
    # a fleet is refused where a single plan is required (the downlink)
    with pytest.raises(TypeError, match="FleetPlan"):
        as_plan(mixed)
    # a per-client plan vector dedupes structurally equal plans
    vec = fleet_from_plans([make_compressor("natural"), Identity(),
                            make_compressor("natural"), Identity()])
    assert vec.n_cohorts == 2 and vec.assignment == (0, 1, 0, 1)
    assert resolve_uplink([plan] * N) is plan


def test_cohort_labels():
    assert cohort_label(make_plan(Identity(), ONE)) == "identity"
    assert cohort_label(make_plan(make_compressor("qsgd", levels=4), ONE,
                                  transport="packed", narrow=True)) == \
        "qsgd4n"
    assert cohort_label(make_plan(make_compressor("natural"), ONE)) == \
        "natural"


# --------------------------------------------------------------------------
# uniform-fleet keystone: every codec x transport x engine, exact
# --------------------------------------------------------------------------

_KEYSTONE_PLANS = [
    ("identity", "leafwise", {}),
    ("qsgd", "leafwise", {}),
    ("qsgd", "flat", {}),
    ("qsgd", "packed", {}),
    ("natural", "flat", {}),
    ("natural", "packed", {}),
    ("qsgd", "packed", {"levels": 4, "narrow": True}),
]


def _keystone_plan(name, transport, opts):
    opts = dict(opts)
    narrow = opts.pop("narrow", False)
    return make_plan(make_compressor(name, **opts), ONE,
                     transport=transport, narrow=narrow)


@pytest.mark.parametrize("name,transport,opts", _KEYSTONE_PLANS)
@pytest.mark.parametrize("participation", [None, 0.5])
def test_uniform_keystone_stacked(name, transport, opts, participation):
    plan = _keystone_plan(name, transport, opts)
    xi = np.asarray([0, 1, 0, 0, 1, 1], np.int32)
    outs = []
    for comp in (plan, as_fleet_plan(plan, N), [plan] * N):
        st, tr = rollout_l2gd(prng.PRNGKey(1), init_state(_zero()), _hp(),
                              _batch(), xi, grad_fn=_grad, client_comp=comp,
                              master_comp=plan, batch_axis=None,
                              participation=participation)
        outs.append((st.params["w"], tr.xis))
    for w, xis in outs[1:]:
        assert torch.equal(w, outs[0][0])
        np.testing.assert_array_equal(xis, outs[0][1])


@pytest.mark.parametrize("name,transport,opts", _KEYSTONE_PLANS)
@pytest.mark.parametrize("participation", [None, 0.5])
def test_uniform_keystone_async(name, transport, opts, participation):
    plan = _keystone_plan(name, transport, opts)
    _, fault_plan = _chaos()
    outs = []
    for comp in (plan, as_fleet_plan(plan, N)):
        st, _, tr = rollout_l2gd_async(
            prng.PRNGKey(2), init_state(_zero()), _hp(), _batch(),
            grad_fn=_grad, fault_plan=fault_plan, steps=8, client_comp=comp,
            master_comp=plan, batch_axis=None, participation=participation)
        outs.append((st.params["w"], tr.events))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


# --------------------------------------------------------------------------
# mixed fleets against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mask", [None, (1.0, 0.0, 1.0, 1.0)])
def test_mixed_fleet_mean_matches_reference(mask):
    """The port's mixed mean against the reference's ``fleet_mean`` on
    the same key words, and against a per-client mean the port builds
    by hand (client i decoded with its own plan and key)."""
    fleet, jfleet = _mixed_fleet(), _jmixed_fleet()
    x = np.array(jax.random.normal(jax.random.PRNGKey(5), (N, D)))
    jkeys = jax.random.split(jax.random.PRNGKey(6), N)
    keys = key_from_words(np.asarray(jkeys))
    m = None if mask is None else np.asarray(mask, np.float32)
    want = jfleet_mean(jfleet, jkeys, {"w": jnp.asarray(x)},
                       None if m is None else jnp.asarray(m))
    got = fleet_mean(fleet, keys, {"w": torch.from_numpy(x)},
                     None if m is None else torch.from_numpy(m))
    _within(got["w"], want["w"])
    contribs = [fleet.plan_for(i).apply(
        keys[i], {"w": torch.from_numpy(x[i])})["w"] for i in range(N)]
    sel = [c for i, c in enumerate(contribs) if m is None or m[i] > 0]
    _within(got["w"], sum(sel) / len(sel))


def test_mixed_compressed_average_uses_client_key_schedule():
    """Client i draws from split(k_clients, n)[i] whatever its cohort:
    compressed_average(fleet) == fleet_mean on those keys."""
    fleet = _mixed_fleet()
    x = {"w": torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(8), (N, D))))}
    key = prng.PRNGKey(9)
    got = compressed_average(key, x, fleet, make_plan(Identity(), ONE))
    k_clients, _ = prng.split(key)
    want = fleet_mean(fleet, prng.split(k_clients, N), x)
    assert torch.equal(got["w"], want["w"])


def test_mixed_fleet_rollout_matches_reference():
    xi = np.asarray([0, 1, 0, 0, 1, 1, 0, 1], np.int32)
    jst, jtr = jrollout.rollout_l2gd(
        jax.random.PRNGKey(3), jinit_state({"w": jnp.zeros((N, D))}), _jhp(),
        jnp.asarray(A), jnp.asarray(xi), grad_fn=quad_grad_fn,
        client_comp=_jmixed_fleet(), master_comp=JIdentity(),
        batch_axis=None)
    st, tr = rollout_l2gd(
        key_from_words(np.asarray(jax.random.PRNGKey(3))),
        init_state(_zero()), _hp(), _batch(), xi, grad_fn=_grad,
        client_comp=_mixed_fleet(), master_comp=Identity(), batch_axis=None)
    np.testing.assert_array_equal(tr.xis, np.asarray(jtr.xis))
    np.testing.assert_array_equal(tr.branches, np.asarray(jtr.branches))
    _within(st.params["w"], jst.params["w"], rounds=3)


def _chaos():
    kw = dict(max_delay=2, drop_rate=0.2, crash_rate=0.1, quorum=0.6)
    return (JFaultPlan(latency_probs=jgeometric(1.0, 4), **kw),
            FaultPlan(latency_probs=geometric_latency_probs(1.0, 4), **kw))


@pytest.mark.parametrize("participation", [None, 0.75])
def test_mixed_fleet_async_matches_reference(participation):
    """The async engine's mixed-fleet rounds (stragglers folded at their
    staleness weights into one-model float32 buffers) against the
    reference's: equal events and ledgers, params within the bound."""
    jplan, plan = _chaos()
    steps_ = 16
    jst, jagg, jtr = jasync(
        jax.random.PRNGKey(11), jinit_state({"w": jnp.zeros((N, D))}),
        _jhp(), jnp.asarray(A), grad_fn=quad_grad_fn, fault_plan=jplan,
        steps=steps_, client_comp=_jmixed_fleet(), master_comp=JIdentity(),
        batch_axis=None, participation=participation)
    st, agg, tr = rollout_l2gd_async(
        key_from_words(np.asarray(jax.random.PRNGKey(11))),
        init_state(_zero()), _hp(), _batch(), grad_fn=_grad,
        fault_plan=plan, steps=steps_, client_comp=_mixed_fleet(),
        master_comp=Identity(), batch_axis=None, participation=participation)
    np.testing.assert_array_equal(tr.xis, np.asarray(jtr.xis))
    np.testing.assert_array_equal(tr.events.numpy(), np.asarray(jtr.events))
    assert int(tr.events[:, 0].sum()) > 0
    rounds = int(np.sum(tr.branches == 1))
    _within(st.params["w"], jst.params["w"], rounds=rounds)
    assert agg.buf["w"].dtype == torch.float32
    assert agg.buf["w"].shape == (plan.n_slots, D)
    fleet = _mixed_fleet()
    vec = fleet.round_bits_vector()
    ledger, jledger = BitsLedger(N), JLedger(N)
    ledger.replay_fault_trace(tr.xis, tr.events[:, 0], tr.events[:, 1],
                              vec, 0.0)
    jledger.replay_fault_trace(np.asarray(jtr.xis),
                               np.asarray(jtr.events)[:, 0],
                               np.asarray(jtr.events)[:, 1],
                               _jmixed_fleet().round_bits_vector(), 0.0)
    assert _ledger(ledger) == _ledger(jledger)


def test_mixed_fleet_async_buffer_layout():
    _, plan = _chaos()
    agg = init_async_state(_zero(), _mixed_fleet(), plan)
    assert agg.buf["w"].shape == (plan.n_slots, D)
    assert agg.buf["w"].dtype == torch.float32
    uniform = init_async_state(_zero(), as_fleet_plan(
        make_plan(make_compressor("natural"), ONE, transport="flat"), N),
        plan)
    assert torch.is_tensor(uniform.buf)       # the flat engine's grid


def test_fleet_size_mismatch_raises():
    fleet = _mixed_fleet(assignment=(0, 1, 2))  # 3 clients, params have N
    with pytest.raises(ValueError, match="covers 3 clients"):
        compressed_average(prng.PRNGKey(0), _zero(), fleet,
                           make_plan(Identity(), ONE))
    _, plan = _chaos()
    with pytest.raises(ValueError, match="covers 3 clients"):
        rollout_l2gd_async(prng.PRNGKey(0), init_state(_zero()), _hp(),
                           _batch(), grad_fn=_grad, fault_plan=plan,
                           steps=2, client_comp=fleet, batch_axis=None)
    with pytest.raises(ValueError, match="covers 3 clients"):
        run_l2gd(prng.PRNGKey(0), _zero(), _grad, _hp(), lambda k: _batch(),
                 2, client_comp=fleet, device="cpu")


# --------------------------------------------------------------------------
# the fleet ledger
# --------------------------------------------------------------------------

def test_per_client_uplink():
    assert per_client_uplink(123.5, N) == 123.5
    assert per_client_uplink((10.0, 20.0, 30.0, 40.0), N) == 25.0
    with pytest.raises(ValueError, match="cover"):
        per_client_uplink((1.0, 2.0), N)


def test_mixed_fleet_conserves_ledger_bits():
    """Full participation, R rounds: fleet total == R * sum_i bits_i."""
    vec = _mixed_fleet().round_bits_vector()
    led = BitsLedger(n_clients=N)
    led.replay_xi_trace([0, 1, 0, 0, 1, 1, 0, 1], vec, 0.0)
    assert led.rounds == 3
    assert led.uplink_bits_per_client * N == 3 * sum(vec)


def test_fleet_ledger_replays_equal_reference():
    """Random (xi, participation, assignment) traces and random event
    counts replay into ledgers equal to the reference's, bit for bit."""
    rng = np.random.default_rng(0)
    for _ in range(30):
        assignment = tuple(int(a) for a in rng.integers(0, 3, N))
        vec = _mixed_fleet(assignment).round_bits_vector()
        assert vec == _jmixed_fleet(assignment).round_bits_vector()
        xis = rng.integers(0, 2, int(rng.integers(1, 25))).tolist()
        part = [None, 0.25, 0.5, 1.0][int(rng.integers(0, 4))]
        ours, theirs = BitsLedger(N), JLedger(N)
        ours.replay_xi_trace(xis, vec, 100.0, participation=part)
        theirs.replay_xi_trace(xis, vec, 100.0, participation=part)
        assert _ledger(ours) == _ledger(theirs)
        scale = 1.0 if part is None else participant_count(N, part) / N
        assert ours.uplink_bits_per_client == sum(
            [scale * per_client_uplink(vec, N)] * ours.rounds, 0.0)
        sent = rng.integers(0, N + 1, len(xis))
        delivered = np.minimum(sent, N - 1)
        drop = bool(rng.integers(0, 2))
        ours, theirs = BitsLedger(N), JLedger(N)
        ours.replay_fault_trace(xis, sent, delivered, vec, 64.0,
                                charge_dropped=drop)
        theirs.replay_fault_trace(xis, sent, delivered, vec, 64.0,
                                  charge_dropped=drop)
        assert _ledger(ours) == _ledger(theirs)


# --------------------------------------------------------------------------
# the driver
# --------------------------------------------------------------------------

def test_driver_mixed_fleet_equals_reference_and_modes():
    """run_l2gd takes a FleetPlan uplink: scan and host modes charge and
    step alike, the charge is rounds * sum_i bits_i / n, and the ledger
    equals the reference driver's."""
    runs = {mode: run_l2gd(prng.PRNGKey(14), _zero(), _grad, _hp(),
                           lambda k: _batch(), 10, client_comp=_mixed_fleet(),
                           master_comp=Identity(), mode=mode, device="cpu")
            for mode in ("scan", "host")}
    vec = _mixed_fleet().round_bits_vector()
    for mode, r in runs.items():
        assert r.ledger.uplink_bits_per_client == \
            r.ledger.rounds * (sum(vec) / N), mode
    assert _ledger(runs["scan"].ledger) == _ledger(runs["host"].ledger)
    assert torch.equal(runs["scan"].state.params["w"],
                       runs["host"].state.params["w"])
    ref = jrun_l2gd(jax.random.PRNGKey(14), {"w": jnp.zeros((N, D))},
                    quad_grad_fn, _jhp(), lambda k: jnp.asarray(A), 10,
                    client_comp=_jmixed_fleet(), master_comp=JIdentity())
    assert _ledger(runs["scan"].ledger) == _ledger(ref.ledger)
    np.testing.assert_array_equal(runs["scan"].xis, np.asarray(ref.xis))
    _within(runs["scan"].state.params["w"], ref.state.params["w"],
            rounds=runs["scan"].ledger.rounds)


def test_driver_uniform_fleet_keystone():
    plan = make_plan(make_compressor("qsgd"), ONE, transport="flat")
    runs = [run_l2gd(prng.PRNGKey(15), _zero(), _grad, _hp(),
                     lambda k: _batch(), 8, client_comp=comp,
                     master_comp=Identity(), device="cpu")
            for comp in (plan, as_fleet_plan(plan, N), [plan] * N)]
    for r in runs[1:]:
        assert _ledger(r.ledger) == _ledger(runs[0].ledger)
        assert torch.equal(r.state.params["w"], runs[0].state.params["w"])


def test_step_builders_take_fleets():
    """The LM builders' uplink: a FleetPlan binds to the model's shapes
    and unwraps when uniform; a per-client vector dedupes."""
    cfg = get_config("stablelm-1.6b").reduced()
    shapes = steps.param_shapes(cfg)
    natural = make_plan(make_compressor("natural"), transport="flat")
    fleet = FleetPlan(cohorts=(natural, make_plan(
        make_compressor("qsgd", levels=4), transport="packed",
        narrow=True)), assignment=(0, 1))
    up = steps._uplink_plan(fleet, shapes)
    assert isinstance(up, FleetPlan) and up.total_round_bits() > 0
    uniform = steps._uplink_plan(as_fleet_plan(natural, 2), shapes)
    assert uniform.codec == natural.codec and uniform.specs is not None
    assert steps._uplink_plan([natural, natural], shapes).transport == \
        "flat"


# --------------------------------------------------------------------------
# the bandwidth-budget controller
# --------------------------------------------------------------------------

def _budget_fleet(params=ONE, make=make_plan, comp=make_compressor,
                  fleet_cls=FleetPlan):
    """Two adjustable qsgd cohorts + one fixed natural cohort."""
    return fleet_cls(cohorts=(
        make(comp("qsgd", levels=127), params, transport="flat"),
        make(comp("qsgd", levels=127), params, transport="packed"),
        make(comp("natural"), params, transport="flat")),
        assignment=(0, 1, 2, 2))


def _levels(fleet):
    return [(p.codec.levels, p.narrow) if p.codec.name == "qsgd" else None
            for p in fleet.cohorts]


def test_controller_equals_reference_and_stays_within_budget():
    fleet = _budget_fleet()
    jfleet = _budget_fleet(J1, jmake_plan, jmake_compressor, JFleetPlan)
    assert fleet.total_round_bits() == jfleet.total_round_bits()
    floor = dataclasses.replace(
        fleet, cohorts=(qsgd_level_plan(fleet.cohorts[0], 1),
                        qsgd_level_plan(fleet.cohorts[1], 1),
                        fleet.cohorts[2]))
    top = fleet.total_round_bits()
    for budget in (0.5 * floor.total_round_bits(),
                   (floor.total_round_bits() + top) / 2, 0.4 * top, top,
                   3 * top):
        ctrl = BandwidthBudgetController(budget_bits_per_round=budget)
        out = ctrl.next_fleet(fleet)
        jout = JController(budget_bits_per_round=budget).next_fleet(jfleet)
        assert _levels(out) == _levels(jout)
        assert _levels(ctrl.next_fleet(fleet)) == _levels(out)
        assert out.total_round_bits() == jout.total_round_bits()
        assert out.cohorts[2] is fleet.cohorts[2]
        if budget >= floor.total_round_bits():
            assert out.total_round_bits() <= budget


def test_controller_ledger_feedback_equals_reference():
    fleet = _budget_fleet()
    jfleet = _budget_fleet(J1, jmake_plan, jmake_compressor, JFleetPlan)
    budget = fleet.total_round_bits()
    ctrl = BandwidthBudgetController(budget_bits_per_round=budget)
    jctrl = JController(budget_bits_per_round=budget)
    for spent in (0.25, 2.0):
        led, jled = BitsLedger(N), JLedger(N)
        led.record_round(spent * budget / N, 0.0)
        jled.record_round(spent * budget / N, 0.0)
        assert ctrl.allowance(led) == jctrl.allowance(jled) == \
            budget * 2 - spent * budget
        assert _levels(ctrl.next_fleet(fleet, led)) == \
            _levels(jctrl.next_fleet(jfleet, jled))
    rich = ctrl.next_fleet(fleet, _spent(0.25 * budget))
    poor = ctrl.next_fleet(fleet, _spent(2.0 * budget))
    assert poor.total_round_bits() <= rich.total_round_bits()


def _spent(bits):
    led = BitsLedger(N)
    led.record_round(bits / N, 0.0)
    return led


def test_controller_validation_and_fixed_fleet():
    with pytest.raises(ValueError, match="positive"):
        BandwidthBudgetController(budget_bits_per_round=0.0)
    with pytest.raises(ValueError, match="ascending"):
        BandwidthBudgetController(1.0, levels_menu=(7, 3))
    with pytest.raises(ValueError, match="int8"):
        BandwidthBudgetController(1.0, levels_menu=(1, 255))
    fixed = FleetPlan(
        cohorts=(make_plan(Identity(), ONE),
                 make_plan(make_compressor("natural"), ONE,
                           transport="flat")),
        assignment=(0, 1, 1, 0))
    ctrl = BandwidthBudgetController(budget_bits_per_round=1.0)
    assert ctrl.next_fleet(fixed) is fixed


def test_controller_drives_a_run():
    """Rounds of run_l2gd under the controller's fleets: the ledger
    stays replayable (each chunk charges its fleet's vector) and the
    schedule is a function of (budget, fleet, ledger) alone."""
    def schedule():
        fleet = _budget_fleet()
        ctrl = BandwidthBudgetController(
            budget_bits_per_round=0.5 * fleet.total_round_bits())
        ledger, chosen = BitsLedger(N), []
        for _ in range(3):
            fleet = ctrl.next_fleet(fleet, ledger)
            chosen.append(_levels(fleet))
            run = run_l2gd(prng.PRNGKey(len(chosen)), _zero(), _grad, _hp(),
                           lambda k: _batch(), 6, client_comp=fleet,
                           master_comp=Identity(), device="cpu")
            ledger.replay_xi_trace(run.xis, fleet.round_bits_vector(), 0.0)
            assert all(np.isfinite(l) for _, l in run.losses)
        return chosen, _ledger(ledger)

    assert schedule() == schedule()
