"""Parity of the rest of the paper in the port with the JAX reference:
the theory calculators, the partitions, the logreg_a1a constants, the
optimizers, the compressor / flat-buffer shims, the error-feedback
extensions, FedAvg / FedOpt and the (p, lambda) grid rollout.

Exact: theory (the same Python floats), partitions (numpy), the
constants, the shims' bit counts, the xi traces, branches and ledgers,
and FedAvg with exact deltas on the quadratic fixture (every operation
is an eager float32 add, subtract or multiply on both sides).

Within a stated bound, with the reason:
  * OPTIM_ULPS: Adam's float32 power ``b ** count`` and square root are
    XLA's and PyTorch's own evaluations (an ulp apart at most), and the
    update divides by them: the params within 4 ulps of max |param| a
    step; SGD and the schedule hold the same bound;
  * compressed runs (QSGD, natural): the bucket norms differ by ulps
    between ``torch.sum`` and XLA (tests/test_torch_qsgd.py), so a rare
    code may sit one level away: within one QSGD level (bucket norm /
    levels) or one natural rounding (a power of two: 2 x |x|) of the
    value, and the losses within LOSS_RTOL; FedAvg's compressed
    difference on the quadratic is tighter: natural bit-exact (its
    rounding reads no norm), QSGD within an ulp of max |w| a round;
  * logistic losses and gradients: the frameworks' matrix-vector
    products and exp / log1p round differently (LOGREG_RTOL per step;
    FedAvg / FedOpt runs of R rounds within R x LOGREG_RTOL of max |w|);
  * the grid's rollouts: XLA contracts the updates' multiply-adds (one
    ulp of the operands a step, as tests/test_torch_l2gd.py states):
    GRID_ULPS_PER_STEP x steps ulps of max |w|.
"""
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_threads import torch_one_thread  # noqa: F401
from conftest import quad_grad_fn
from repro import optim as joptim
from repro.configs import logreg_a1a as jlogreg_a1a
from repro.core import compressors as jcomp
from repro.core import extensions as jext
from repro.core import flatbuf as jflat
from repro.core import make_plan as jmake_plan
from repro.core import rollout as jrollout
from repro.core import theory as jtheory
from repro.data import logreg_loss_and_grad as jlogreg
from repro.data import make_logreg_data
from repro.data import partition as jpartition
from repro.fl import fedavg as jfedavg
from repro.fl import run_fedavg as jrun_fedavg
from repro.fl import run_fedopt as jrun_fedopt
from repro_torch import optim
from repro_torch.configs import logreg_a1a
from repro_torch.convert import key_from_words, params_from_numpy
from repro_torch.core import (L2GDHyper, compressors, extensions, flatbuf,
                              hyper_grid, make_compressor, make_plan, prng,
                              rollout_l2gd_grid, theory)
from repro_torch.core.codec import CompressionPlan
from repro_torch.data import logreg_loss_and_grad, partition
from repro_torch.fl import run_fedavg, run_fedopt
from repro_torch.fl.fedavg import local_sgd_epochs

OPTIM_ULPS = 4
LOSS_RTOL = 1e-3
LOGREG_RTOL = 1e-5
GRID_ULPS_PER_STEP = 1
N, D = 4, 6
TARGETS = np.array(jax.random.normal(jax.random.PRNGKey(0), (N, D)))
CODECS = ("identity", "qsgd", "natural", "terngrad", "bernoulli", "randk",
          "topk")


def _ulps(got, want, scale=None):
    """max |got - want| in float32 ulps of ``scale`` (default max |want|)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.max(np.abs(want))) if scale is None else scale
    return float(np.max(np.abs(got - want))) / float(
        np.spacing(np.float32(max(scale, 1e-30))))


def _ledger(ledger):
    """A ledger's fields (the two packages' BitsLedger classes differ)."""
    return (ledger.n_clients, ledger.uplink_bits_per_client,
            ledger.downlink_bits_per_client, ledger.rounds, ledger.history)


def _key(seed):
    k = jax.random.PRNGKey(seed)
    return k, key_from_words(np.asarray(k))


# --------------------------------------------------------------------------
# theory, partitions, constants: exact
# --------------------------------------------------------------------------

THEORY_CASES = [(2.0, 0.5, 10.0, 8), (0.3, 0.1, 1.5, 5), (5.0, 2.0, 0.7, 32)]


@pytest.mark.parametrize("L_f,mu,lam,n", THEORY_CASES)
def test_theory_equals_reference(L_f, mu, lam, n):
    assert sorted(theory.__all__) == sorted(jtheory.__all__)
    c = theory.SmoothnessConstants(L_f=L_f, mu=mu, lam=lam, n=n)
    jc = jtheory.SmoothnessConstants(L_f=L_f, mu=mu, lam=lam, n=n)
    assert c.L == jc.L
    for omega, omega_m in ((0.0, 0.0), (0.125, 0.0), (2.5, 0.125)):
        assert theory.alpha_beta(c, omega, omega_m, 1.7, 0.3) == \
            jtheory.alpha_beta(jc, omega, omega_m, 1.7, 0.3)
        alpha = theory.alpha_beta(c, omega, omega_m)[0]
        for p in (0.1, 0.37, 0.8):
            assert theory.gamma_of_p(c, alpha, p) == \
                jtheory.gamma_of_p(jc, alpha, p)
            assert theory.gamma_delta(c, omega, omega_m, p, 1.3, 0.2, 0.1) \
                == jtheory.gamma_delta(jc, omega, omega_m, p, 1.3, 0.2, 0.1)
            assert theory.A_rate(c, alpha, p) == jtheory.A_rate(jc, alpha, p)
            assert theory.B_rate(c, alpha, p) == jtheory.B_rate(jc, alpha, p)
            gamma, delta = theory.gamma_delta(c, omega, omega_m, p)
            assert theory.theorem1_rate(c, gamma, delta) == \
                jtheory.theorem1_rate(jc, gamma, delta)
            assert theory.iteration_complexity(c, gamma, 1e-3, 2.0) == \
                jtheory.iteration_complexity(jc, gamma, 1e-3, 2.0)
        for fn in ("p_A_rate", "p_star_rate", "p_A_comm", "p_star_comm"):
            assert getattr(theory, fn)(c, alpha) == \
                getattr(jtheory, fn)(jc, alpha)
    assert theory.p_e(c) == jtheory.p_e(jc)
    with pytest.raises(ValueError, match="Theorem 1"):
        theory.theorem1_rate(c, 1.0, 0.0, eta=1.0)


@pytest.mark.parametrize("n_clients,alpha,seed", [(5, 0.5, 0), (8, 0.1, 3),
                                                  (3, 5.0, 7)])
def test_partitions_equal_reference(n_clients, alpha, seed):
    labels = np.random.default_rng(seed).integers(0, 4, size=400)
    ours = partition.dirichlet_partition(labels, n_clients, alpha, seed)
    theirs = jpartition.dirichlet_partition(labels, n_clients, alpha, seed)
    assert len(ours) == len(theirs) == n_clients
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(partition.shard_partition(403, n_clients, seed),
                    jpartition.shard_partition(403, n_clients, seed)):
        np.testing.assert_array_equal(a, b)


def test_logreg_a1a_constants_equal_reference():
    for name in ("D_FEATURES", "N_CLIENTS", "L2"):
        assert getattr(logreg_a1a, name) == getattr(jlogreg_a1a, name)


# --------------------------------------------------------------------------
# optimizers
# --------------------------------------------------------------------------

def _optim_inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = {"a": rng.normal(size=(3, 5)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{"a": rng.normal(size=(3, 5)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
             for _ in range(6)]
    return params, grads


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_reference(momentum):
    params, grads = _optim_inputs()
    jp, tp = jax.tree.map(jnp.asarray, params), params_from_numpy(params)
    js, ts = joptim.sgd_init(jp, momentum), optim.sgd_init(tp, momentum)
    assert (js is None) == (ts is None)
    for g in grads:
        jp, js = joptim.sgd_update(jp, jax.tree.map(jnp.asarray, g), js,
                                   0.05, momentum)
        tp, ts = optim.sgd_update(tp, params_from_numpy(g), ts, 0.05,
                                  momentum)
    for k in params:
        assert _ulps(tp[k].numpy(), jp[k]) <= OPTIM_ULPS * len(grads)


def test_adam_matches_reference():
    params, grads = _optim_inputs(1)
    jp, tp = jax.tree.map(jnp.asarray, params), params_from_numpy(params)
    js, ts = joptim.adam_init(jp), optim.adam_init(tp)
    assert ts.count.dtype == torch.int32 and int(ts.count) == 0
    for step, g in enumerate(grads, 1):
        jp, js = joptim.adam_update(jp, jax.tree.map(jnp.asarray, g), js,
                                    1e-2)
        tp, ts = optim.adam_update(tp, params_from_numpy(g), ts, 1e-2)
        assert int(ts.count) == int(js.count) == step
        for k in params:
            assert _ulps(tp[k].numpy(), jp[k]) <= OPTIM_ULPS * step
            assert _ulps(ts.mu[k].numpy(), js.mu[k]) <= OPTIM_ULPS * step
            assert _ulps(ts.nu[k].numpy(), js.nu[k]) <= OPTIM_ULPS * step


def test_cosine_schedule_matches_reference():
    ours, theirs = optim.cosine_schedule(3e-3, 10, 100), \
        joptim.cosine_schedule(3e-3, 10, 100)
    for step in (0, 1, 5, 10, 11, 37, 99, 100, 150):
        got, want = ours(step), np.asarray(theirs(step))
        assert got.dtype == torch.float32
        assert _ulps(got.numpy(), want) <= OPTIM_ULPS


# --------------------------------------------------------------------------
# the shims
# --------------------------------------------------------------------------

_TREE = {"emb": np.zeros((40, 17), np.float32), "w": np.zeros((5,),
                                                              np.float32),
         "s": np.zeros((), np.float32)}


@pytest.mark.parametrize("name", CODECS)
def test_tree_wire_bits_equal_reference(name):
    tree = params_from_numpy(_TREE)
    jtree = jax.tree.map(jnp.asarray, _TREE)
    comp, jc = make_compressor(name), jcomp.make_compressor(name)
    transports = [None, "leafwise"] + (["flat", "packed"]
                                       if name in ("qsgd", "natural") else [])
    for transport in transports:
        assert compressors.tree_wire_bits(comp, tree, transport=transport) \
            == jcomp.tree_wire_bits(jc, jtree, transport=transport)
    with pytest.warns(DeprecationWarning):
        ours = compressors.tree_wire_bits(comp, tree, flat=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert ours == jcomp.tree_wire_bits(jc, jtree, flat=False)


def test_joint_omega_and_wire_bit_shims():
    assert compressors.joint_omega([0.1, 3.0, 0.5]) == \
        jcomp.joint_omega([0.1, 3.0, 0.5]) == 3.0
    for shape in ((124,), (3, 2048), (5000,), (0,)):
        tree = {"w": torch.zeros(shape)}
        jtree = {"w": jnp.zeros(shape)}
        for bucket in (128, 2048):
            assert flatbuf.packed_wire_bits(tree, bucket=bucket) == \
                jflat.packed_wire_bits(jtree, bucket=bucket)
    x = np.random.default_rng(0).normal(size=(3000,)).astype(np.float32)
    jk, tk = _key(3)
    payload = make_plan(make_compressor("qsgd"), {"w": torch.zeros(3000)},
                        transport="packed").encode(tk,
                                                   {"w": torch.from_numpy(x)})
    jpay = jmake_plan(jcomp.make_compressor("qsgd"), {"w": jnp.zeros(3000)},
                      transport="packed").encode(jk, {"w": jnp.asarray(x)})
    assert flatbuf.payload_wire_bits(payload) == \
        jflat.payload_wire_bits(jpay) == 8 * 4096 + 2 * 32


def test_unpack_tree_qsgd_equals_reference():
    rng = np.random.default_rng(1)
    tree = {"a": rng.normal(size=(30, 70)).astype(np.float32),
            "b": rng.normal(size=(9,)).astype(np.float32)}
    jk, tk = _key(5)
    payload, layout = flatbuf.pack_tree_qsgd(tk, params_from_numpy(tree),
                                             levels=7, bucket=256)
    jpay, jlayout = jflat.pack_tree_qsgd(jk, jax.tree.map(jnp.asarray, tree),
                                         levels=7, bucket=256)
    np.testing.assert_array_equal(payload.codes.numpy(),
                                  np.asarray(jpay.codes))
    ours = flatbuf.unpack_tree_qsgd(payload)
    theirs = jflat.unpack_tree_qsgd(jpay)
    # a hand-built payload (no layout): the layout and levels are passed
    bare = type(payload)(payload.codes, payload.norms, levels=7)
    again = flatbuf.unpack_tree_qsgd(bare, layout, levels=7)
    for k in tree:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]),
                                   rtol=2e-6, atol=0)
        assert torch.equal(again[k], ours[k])


@pytest.mark.parametrize("name", ["identity", "qsgd", "natural", "topk",
                                  "randk"])
def test_tree_apply_equals_reference(name):
    x = {"w": np.random.default_rng(2).normal(size=(N, 300))
         .astype(np.float32)}
    jk, tk = _key(4)
    comp, jc = make_compressor(name), jcomp.make_compressor(name)
    n_keys = prng.split(tk, N)
    ours = compressors.tree_apply(comp, n_keys, params_from_numpy(x))
    theirs = jax.vmap(lambda k, p: jcomp.tree_apply(jc, k, p))(
        jax.random.split(jk, N), jax.tree.map(jnp.asarray, x))
    _assert_compressed_close(name, ours["w"].numpy(), np.asarray(theirs["w"]),
                             x["w"])
    with pytest.warns(DeprecationWarning):
        compressors.tree_apply(comp, tk, {"w": torch.ones(8)}, flat=None)


def _assert_compressed_close(name, got, want, x):
    """Compressed values: equal, or within one quantization step where an
    ulp of the bucket norm moves a code (module docstring); at most 1% of
    the values sit a step apart (the rest differ by the norm's ulps)."""
    diff = np.abs(got - want)
    if name == "qsgd":
        level = float(np.max(np.linalg.norm(x.reshape(-1, x.shape[-1]),
                                            axis=-1))) / 127
        assert np.max(diff) <= level * 1.0001
        assert np.mean(diff > level / 2) <= 0.01
    elif name == "natural":
        assert np.all(diff <= 2 * np.abs(x) + 1e-30)
        assert np.mean(diff > np.abs(want) / 4) <= 0.01
    else:
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# the extensions: error feedback and compressed gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["identity", "topk", "qsgd", "natural"])
def test_ef_average_matches_reference(name):
    rng = np.random.default_rng(3)
    x = {"w": rng.normal(size=(N, 96)).astype(np.float32)}
    comp, jc = make_compressor(name), jcomp.make_compressor(name)
    ident, jident = make_compressor("identity"), jcomp.Identity()
    tp, jp = params_from_numpy(x), jax.tree.map(jnp.asarray, x)
    mem, jmem = extensions.init_ef_memory(tp), jext.init_ef_memory(jp)
    for step in range(3):
        jk, tk = _key(10 + step)
        corrected = x["w"] + np.asarray(jmem.residual["w"])
        target, mem = extensions.ef_average(tk, tp, mem, comp, ident)
        jtarget, jmem = jext.ef_average(jk, jp, jmem, jc, jident)
        # the residual is the input less its compressed value
        _assert_compressed_close(name, mem.residual["w"].numpy(),
                                 np.asarray(jmem.residual["w"]), corrected)
        got, want = target["w"].numpy(), np.asarray(jtarget["w"])
        if name in ("identity", "topk"):
            assert _ulps(got, want) <= OPTIM_ULPS
        else:
            # the mean of N messages: a value a step apart moves it by
            # step / N (one QSGD level, or 2 |x| for natural)
            step_size = np.max(np.linalg.norm(corrected, axis=-1)) / 127 \
                if name == "qsgd" else 2 * np.max(np.abs(corrected))
            assert np.max(np.abs(got - want)) <= step_size / N * 1.0001


@pytest.mark.parametrize("name", ["identity", "qsgd", "natural", "bernoulli"])
def test_compress_grads_matches_reference(name):
    g = {"w": np.random.default_rng(4).normal(size=(N, 200))
         .astype(np.float32)}
    jk, tk = _key(21)
    ours = extensions.compress_grads(tk, params_from_numpy(g),
                                     make_compressor(name))
    theirs = jext.compress_grads(jk, jax.tree.map(jnp.asarray, g),
                                 jcomp.make_compressor(name))
    _assert_compressed_close(name, ours["w"].numpy(),
                             np.asarray(theirs["w"]), g["w"])


def test_ef_topk_l2gd_beats_plain_topk():
    """The reference's EF test (tests/test_extensions.py) on the port,
    800 steps: L2GD with top-k + EF ends closer to x* than plain top-k."""
    from repro_torch.core import (aggregation_update, compressed_average,
                                  local_update)
    n, d = 8, 32
    A = torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(0), (n, d))))
    hp = L2GDHyper(eta=0.3, lam=1.0, p=0.3, n=n)
    comp, ident = make_compressor("topk", fraction=0.1), \
        make_compressor("identity")
    xstar = (A + hp.lam * A.mean(0)) / (1 + hp.lam)

    def run(use_ef):
        rng = np.random.default_rng(0)
        params = {"w": torch.zeros(n, d)}
        mem = extensions.init_ef_memory(params)
        key = prng.PRNGKey(1)
        cache = {"w": torch.zeros(d)}
        avg, cnt, xi_prev = torch.zeros(n, d), 0, 1
        for t in range(800):
            key, sub = prng.split(key)
            xi = int(rng.random() < hp.p)
            if xi == 0:
                params = local_update(params, {"w": params["w"] - A}, hp)
            else:
                if xi_prev == 0:
                    if use_ef:
                        cache, mem = extensions.ef_average(sub, params, mem,
                                                           comp, ident)
                    else:
                        cache = compressed_average(sub, params, comp, ident)
                params = aggregation_update(params, cache, hp)
            xi_prev = xi
            if t >= 600:
                avg, cnt = avg + params["w"], cnt + 1
        return float(torch.linalg.norm(avg / cnt - xstar)
                     / torch.linalg.norm(xstar))

    assert run(True) < run(False)


# --------------------------------------------------------------------------
# FedAvg / FedOpt
# --------------------------------------------------------------------------

def _quad_torch(params, batch):
    g = params["w"] - batch
    return 0.5 * torch.sum(g ** 2), {"w": g}


def _fed_kw(rounds, epochs=1):
    return dict(client_batches_fn=lambda r, i: [TARGETS[i]] * epochs,
                n_clients=N, rounds=rounds, local_lr=0.3)


def _run_both(jfn, tfn, seed=1, rounds=6, epochs=1, **kw):
    jk, tk = _key(seed)
    jkw = _fed_kw(rounds, epochs)
    tkw = dict(jkw, client_batches_fn=lambda r, i: [
        torch.from_numpy(TARGETS[i])] * epochs)
    theirs = jfn(jk, {"w": jnp.zeros((D,))}, quad_grad_fn, **jkw,
                 **kw.get("jkw", {}))
    ours = tfn(tk, {"w": torch.zeros(D)}, _quad_torch, **tkw, device="cpu",
               **kw.get("tkw", {}))
    return ours, theirs


def test_fedavg_exact_deltas_bit_exact():
    """No compression on the quadratic: every operation is an eager
    float32 add, subtract, multiply or divide on both sides."""
    ours, theirs = _run_both(jrun_fedavg, run_fedavg, rounds=8, epochs=2)
    np.testing.assert_array_equal(ours.params["w"].numpy(),
                                  np.asarray(theirs.params["w"]))
    assert _ledger(ours.ledger) == _ledger(theirs.ledger)
    assert [r for r, _ in ours.losses] == [r for r, _ in theirs.losses]
    np.testing.assert_allclose([l for _, l in ours.losses],
                               [l for _, l in theirs.losses], rtol=1e-6)


@pytest.mark.parametrize("name", ["identity", "qsgd", "natural"])
def test_fedavg_compressed_difference_matches_reference(name):
    """The compressed-difference schema with its EF memory, the per-client
    ``split(key)`` schedule and the ledger's payload-spec charge."""
    ours, theirs = _run_both(
        jrun_fedavg, run_fedavg, rounds=6,
        jkw={"compressor": jcomp.make_compressor(name)},
        tkw={"compressor": make_compressor(name)})
    assert _ledger(ours.ledger) == _ledger(theirs.ledger)
    assert ours.ledger.rounds == 6
    assert ours.ledger.uplink_bits_per_client == 6 * make_plan(
        make_compressor(name), {"w": torch.zeros(D)}).round_bits()
    got, want = ours.params["w"].numpy(), np.asarray(theirs.params["w"])
    if name in ("identity", "natural"):
        # natural's rounding reads only its input's bits and the threefry
        # bits (no norm), and the EF memory's adds are eager float32 on
        # both sides: with the same key schedule the run is bit-exact
        np.testing.assert_array_equal(got, want)
    else:
        # the bucket norm may differ by its ulps (the sums' order): an ulp
        # of max |w| a round; a code that flipped on such an ulp would
        # move the average by a whole level and show here (none does)
        ulp = np.spacing(np.float32(np.max(np.abs(want))))
        assert np.max(np.abs(got - want)) <= 6 * ulp
    np.testing.assert_allclose([l for _, l in ours.losses],
                               [l for _, l in theirs.losses], rtol=LOSS_RTOL)


def test_fedavg_takes_a_leafwise_plan(monkeypatch):
    """A ready leafwise QSGD plan as the compressor (the LM phase's
    uplink): the reference's run_fedavg cannot take a plan, so its
    make_plan is pinned to leafwise for the comparison."""
    real = jfedavg.make_plan
    monkeypatch.setattr(jfedavg, "make_plan", lambda c, p: real(
        c, p, transport="leafwise" if c.name == "qsgd" else None))
    plan = make_plan(make_compressor("qsgd"), transport="leafwise")
    assert isinstance(plan, CompressionPlan) and plan.specs is None
    ours, theirs = _run_both(
        jrun_fedavg, run_fedavg, rounds=5,
        jkw={"compressor": jcomp.make_compressor("qsgd")},
        tkw={"compressor": plan})
    assert _ledger(ours.ledger) == _ledger(theirs.ledger)
    want = np.asarray(theirs.params["w"])
    ulp = np.spacing(np.float32(np.max(np.abs(want))))   # a round, as above
    assert np.max(np.abs(ours.params["w"].numpy() - want)) <= 5 * ulp


def test_fedopt_matches_reference():
    ours, theirs = _run_both(jrun_fedopt, run_fedopt, rounds=8,
                             jkw={"server_lr": 0.1}, tkw={"server_lr": 0.1})
    assert _ledger(ours.ledger) == _ledger(theirs.ledger)
    assert _ulps(ours.params["w"].numpy(), theirs.params["w"]) <= \
        OPTIM_ULPS * 8
    avg, _ = _run_both(jrun_fedavg, run_fedavg, rounds=8)
    assert not np.allclose(ours.params["w"].numpy(), avg.params["w"].numpy())


def test_fedavg_fig7_recovers_l2gd_on_logreg():
    """Paper Fig 7 on the logistic-regression fixture (the reference's
    bench_fig7_fedavg_recovery at 60 L2GD steps and 30 rounds): L2GD at
    agg_scale 1 and FedAvg at the matched local rate, port against
    reference, and the gap between them small."""
    from repro_torch.fl import run_l2gd
    data = make_logreg_data(n_clients=5, seed=0)
    X, Y = torch.from_numpy(data.features), torch.from_numpy(data.labels)
    JX, JY = jnp.asarray(data.features), jnp.asarray(data.labels)
    n, p, eta = 5, 0.5, 0.5
    hp = L2GDHyper(eta=eta, lam=n * p / eta, p=p, n=n)
    assert abs(hp.agg_scale - 1.0) < 1e-6

    def tgrad(w, b):
        loss, g = logreg_loss_and_grad(w["w"], b[0], b[1], 0.01)
        return loss, {"w": g}

    def jgrad(w, b):
        loss, g = jlogreg(w["w"], b[0], b[1], 0.01)
        return loss, {"w": g}

    lr = eta / (n * (1 - p))
    jk, tk = _key(1)
    fa = run_fedavg(tk, {"w": torch.zeros(124)}, tgrad,
                    lambda r, i: [(X[i], Y[i])], n, 30, local_lr=lr,
                    device="cpu")
    jfa = jrun_fedavg(jk, {"w": jnp.zeros((124,))}, jgrad,
                      lambda r, i: [(JX[i], JY[i])], n, 30, local_lr=lr)
    assert _ledger(fa.ledger) == _ledger(jfa.ledger)
    w = fa.params["w"]
    assert float(torch.max(torch.abs(w - torch.from_numpy(
        np.array(jfa.params["w"]))))) <= 30 * LOGREG_RTOL * float(
            torch.max(torch.abs(w)))
    fa_loss = float(torch.mean(logreg_loss_and_grad(w, X, Y)[0]))
    run = run_l2gd(prng.PRNGKey(0), {"w": torch.zeros(n, 124)},
                   lambda pp, b: (logreg_loss_and_grad(pp["w"], b[0], b[1],
                                                       0.01)[0],
                                  {"w": logreg_loss_and_grad(
                                      pp["w"], b[0], b[1], 0.01)[1]}),
                   hp, lambda k: (X, Y), 60, device="cpu")
    l2gd_loss = float(torch.mean(logreg_loss_and_grad(
        run.state.params["w"], X, Y)[0]))
    assert abs(l2gd_loss - fa_loss) < 0.1


def test_local_sgd_epochs_leaves_params():
    p = {"w": torch.ones(D)}
    out, loss = local_sgd_epochs(p, _quad_torch,
                                 [torch.from_numpy(TARGETS[0])] * 2, 0.25)
    assert torch.equal(p["w"], torch.ones(D))
    jout, jloss = jfedavg.local_sgd_epochs({"w": jnp.ones(D)}, quad_grad_fn,
                                           [jnp.asarray(TARGETS[0])] * 2,
                                           0.25)
    np.testing.assert_array_equal(out["w"].numpy(), np.asarray(jout["w"]))
    assert loss == pytest.approx(jloss, rel=1e-6)


def test_fedavg_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_fedavg(prng.PRNGKey(0), {"w": torch.zeros(D)}, _quad_torch,
                   lambda r, i: [torch.zeros(D)], 2, 1, 0.1)


# --------------------------------------------------------------------------
# the (p, lambda) grid
# --------------------------------------------------------------------------

def test_hyper_grid_equals_reference():
    rule = lambda P, L: np.minimum(0.4, 5 * P / L)
    hp, shape = hyper_grid([0.2, 0.5, 0.8], [0.5, 2.0, 10.0], rule, 5)
    jhp, jshape = jrollout.hyper_grid([0.2, 0.5, 0.8], [0.5, 2.0, 10.0],
                                      rule, 5)
    assert shape == jshape == (3, 3) and hp.n == jhp.n == 5
    for f in ("eta", "lam", "p"):
        np.testing.assert_array_equal(np.asarray(getattr(hp, f)),
                                      np.asarray(getattr(jhp, f)))
    with pytest.raises(ValueError):
        hyper_grid([0.2, 1.0], [1.0], 0.1, 5)


@pytest.mark.parametrize("name", ["identity", "qsgd"])
def test_grid_rollout_matches_reference(name):
    """A 3 x 3 (p, lambda) grid of 12-step rollouts on the quadratic:
    every cell shares the key (the same uniforms thresholded at its own
    p); xi traces, branches and counters exact."""
    steps = 12
    hp, shape = hyper_grid([0.2, 0.5, 0.8], [0.5, 1.0, 4.0], 0.3, N)
    jhp, _ = jrollout.hyper_grid([0.2, 0.5, 0.8], [0.5, 1.0, 4.0], 0.3, N)
    jk, tk = _key(2)
    comp, jc = make_compressor(name), jcomp.make_compressor(name)
    jstates, jtraces = jrollout.rollout_l2gd_grid(
        jk, {"w": jnp.zeros((N, D))}, jhp, jnp.asarray(TARGETS),
        grad_fn=quad_grad_fn, steps=steps, client_comp=jc, master_comp=jc,
        batch_axis=None)

    def tgrad(p, b):
        g = p["w"] - b
        return 0.5 * torch.sum(g ** 2, dim=1), {"w": g}

    states, traces = rollout_l2gd_grid(
        tk, {"w": torch.zeros(N, D)}, hp, torch.from_numpy(TARGETS),
        grad_fn=tgrad, steps=steps, client_comp=comp, master_comp=comp,
        batch_axis=None)
    np.testing.assert_array_equal(traces.xis, np.asarray(jtraces.xis))
    np.testing.assert_array_equal(traces.branches,
                                  np.asarray(jtraces.branches))
    for f in ("n_local", "n_agg_comm", "n_agg_cached"):
        np.testing.assert_array_equal(getattr(traces, f),
                                      np.asarray(getattr(jtraces, f)))
    np.testing.assert_array_equal(states.step, np.asarray(jstates.step))
    got, want = states.params["w"].numpy(), np.asarray(jstates.params["w"])
    assert got.shape == want.shape == (9, N, D)
    if name == "identity":
        assert _ulps(got, want) <= GRID_ULPS_PER_STEP * steps
    else:
        # QSGD: within one level of the downlink quantizer per round
        rounds = int(np.max(traces.n_agg_comm))
        assert np.max(np.abs(got - want)) <= rounds * np.max(
            np.linalg.norm(want.mean(1), axis=-1)) / 127
    np.testing.assert_allclose(traces.losses.numpy(),
                               np.asarray(jtraces.losses), rtol=LOSS_RTOL)
