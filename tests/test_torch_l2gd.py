"""Parity of the port's L2GD step, rollout and driver with the JAX
reference, on the quadratic fixture (tests/conftest.py) and the
quickstart's logistic-regression configuration (examples/quickstart.py).

Exact: the xi realization, branch ids and counts, the bits ledger (bits,
rounds, history), the step scalings and the port's own scan == host.

Within tolerance, with the reason:
  * updates: XLA:CPU contracts ``x - c * (x - t)`` and ``x - s * g`` into
    FMAs; the port rounds the product first (so does its CUDA path), one
    ulp of the operands per update;
  * logistic losses: the matrix-vector product and the exp / log1p
    evaluations of XLA and PyTorch round differently (relative 1e-5);
  * QSGD runs: bucket norms differ by ulps (tests/test_torch_qsgd.py), so
    a rare code may sit one level away: params within one level of the
    downlink quantizer (norm of the mean model / levels), losses within
    QSGD_LOSS_RTOL.  chip_smoke.py holds the port's GPU run to its CPU run
    with the same two bounds.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_threads import torch_one_thread  # noqa: F401
from conftest import quad_batch, quad_grad_fn
from repro.core import L2GDHyper as JHyper
from repro.core import init_state as jinit
from repro.core import l2gd_step as jstep
from repro.core import make_compressor as jmake
from repro.core import make_plan as jplan
from repro.data import logreg_loss_and_grad as jlogreg
from repro.data import make_logreg_data
from repro.fl import run_l2gd as jrun
from repro_torch.convert import key_from_words, params_from_numpy
from repro_torch.core import L2GDHyper, L2GDState, aggregation_update
from repro_torch.core import l2gd_step, local_update
from repro_torch.core import make_compressor, make_plan
from repro_torch.core import prng
from repro_torch.data import logreg_loss_and_grad
from repro_torch.fl import run_l2gd

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
QSGD_LOSS_RTOL = 1e-3
CODECS = [("identity", None), ("qsgd", None), ("qsgd", "packed")]


def _quad_torch(params, batch):
    g = params["w"] - batch
    return 0.5 * torch.sum(g ** 2, dim=1), {"w": g}


def _plans(name, transport, one_jax, one_torch):
    jc, tc = jmake(name), make_compressor(name)
    if transport is None:
        return (jc, jc), (tc, tc)
    return ((jplan(jc, one_jax, transport=transport), jc),
            (make_plan(tc, one_torch, transport=transport), tc))


def _f32_hyper(**kw):
    # the reference driver's normalization: float32 device scalars
    return jax.tree_util.tree_map(jnp.asarray, JHyper(**kw))


def _ulp_bound(*arrays):
    return 2 * np.spacing(np.float32(max(np.abs(a).max() for a in arrays)))


@pytest.mark.parametrize("eta,lam,p,n", [(0.5, 1.0, 0.3, 5), (0.3, 0.7, 0.4, 4),
                                         (0.1, 3.0, 0.9, 8)])
def test_step_scalings_exact(eta, lam, p, n):
    jh = _f32_hyper(eta=eta, lam=lam, p=p, n=n)
    th = L2GDHyper(eta=eta, lam=lam, p=p, n=n)
    assert th.local_scale == np.float32(jh.local_scale)
    assert th.agg_scale == np.float32(jh.agg_scale)


def test_updates_round_each_operation():
    """The port's updates are the float32 expressions with one rounding
    per operation (the CUDA path's arithmetic), and within an FMA's ulp
    of the reference's."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 300)).astype(np.float32)
    g = rng.normal(size=(4, 300)).astype(np.float32)
    t = rng.normal(size=300).astype(np.float32)
    th = L2GDHyper(eta=0.3, lam=0.7, p=0.4, n=4)
    jh = _f32_hyper(eta=0.3, lam=0.7, p=0.4, n=4)
    s, c = th.local_scale, th.agg_scale
    loc = local_update({"w": torch.from_numpy(x)}, {"w": torch.from_numpy(g)},
                       th)["w"].numpy()
    agg = aggregation_update({"w": torch.from_numpy(x)},
                             {"w": torch.from_numpy(t)}, th)["w"].numpy()
    np.testing.assert_array_equal(loc, x - s * g)
    np.testing.assert_array_equal(agg, x - c * (x - t[None]))
    from repro.core.l2gd import aggregation_update as jagg_update
    from repro.core.l2gd import local_update as jlocal_update
    jloc = np.asarray(jlocal_update({"w": x}, {"w": g}, jh)["w"])
    jagg = np.asarray(jagg_update({"w": x}, {"w": t}, jh)["w"])
    assert np.max(np.abs(loc - jloc)) <= _ulp_bound(x, s * g)
    assert np.max(np.abs(agg - jagg)) <= _ulp_bound(x, c * (x - t[None]))


@pytest.mark.parametrize("name,transport", CODECS)
def test_l2gd_step_per_branch(name, transport):
    """Every branch from an identical state: branch ids, step counters
    and the cached target are exact; params within the stated bound."""
    n, d = 4, 12
    a = np.array(quad_batch(n, d))
    p0 = np.random.default_rng(1).normal(size=(n, d)).astype(np.float32)
    jh = _f32_hyper(eta=0.3, lam=0.7, p=0.4, n=n)
    th = L2GDHyper(eta=0.3, lam=0.7, p=0.4, n=n)
    (jup, jdown), (tup, tdown) = _plans(name, transport, {"w": jnp.zeros(d)},
                                        {"w": torch.zeros(d)})
    jst = jinit({"w": jnp.asarray(p0)})
    step = jax.jit(lambda s, x, k: jstep(s, jnp.asarray(a), x, k,
                                         quad_grad_fn, jh, jup, jdown))
    key = jax.random.PRNGKey(5)
    seen = set()
    for xi in [0, 1, 1, 0, 1, 1, 0]:
        key, sub = jax.random.split(key)
        tst = L2GDState(params_from_numpy({"w": np.array(jst.params["w"])}),
                        params_from_numpy({"w": np.array(jst.cache["w"])}),
                        int(jst.xi_prev), int(jst.step))
        jst, jm = step(jst, jnp.int32(xi), sub)
        tst, tm = l2gd_step(tst, torch.from_numpy(a), xi,
                            key_from_words(np.asarray(sub)), _quad_torch, th,
                            tup, tdown)
        seen.add(tm["branch"])
        assert tm["branch"] == int(jm["branch"])
        assert (tst.xi_prev, tst.step) == (int(jst.xi_prev), int(jst.step))
        jw, tw = np.asarray(jst.params["w"]), tst.params["w"].numpy()
        jc, tc = np.asarray(jst.cache["w"]), tst.cache["w"].numpy()
        bound = _ulp_bound(jw, p0)
        if tm["branch"] == 1 and name != "identity":
            # a fresh QSGD target: one level of the downlink quantizer
            bound += np.sqrt(np.sum(jc ** 2)) / 127
            np.testing.assert_allclose(tc, jc, rtol=0, atol=bound)
        else:   # carried over, or the identity mean: exact
            np.testing.assert_array_equal(tc, jc)
        np.testing.assert_allclose(tw, jw, rtol=0, atol=bound)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-6)
    assert seen == {0, 1, 2}


def _logreg_problem():
    data = make_logreg_data(n_clients=5, heterogeneity=1.5, seed=0)
    X, Y = jnp.asarray(data.features), jnp.asarray(data.labels)
    TX, TY = torch.from_numpy(data.features), torch.from_numpy(data.labels)

    def jgrad(p, b):
        loss, g = jlogreg(p["w"], b[0], b[1], 0.01)
        return loss, {"w": g}

    def tgrad(p, b):
        loss, g = logreg_loss_and_grad(p["w"], b[0], b[1], 0.01)
        return loss, {"w": g}

    return (X, Y), (TX, TY), jgrad, tgrad


def _check_run(jr, tr, atol_params, rtol_loss):
    np.testing.assert_array_equal(tr.xis, np.asarray(jr.xis))
    assert (tr.n_local, tr.n_agg_comm, tr.n_agg_cached) == \
        (jr.n_local, jr.n_agg_comm, jr.n_agg_cached)
    assert tr.ledger.rounds == jr.ledger.rounds
    assert tr.ledger.uplink_bits_per_client == jr.ledger.uplink_bits_per_client
    assert tr.ledger.downlink_bits_per_client == \
        jr.ledger.downlink_bits_per_client
    assert tr.ledger.history == jr.ledger.history
    jl = np.array([v for _, v in jr.losses])
    tl = np.array([v for _, v in tr.losses])
    assert [k for k, _ in tr.losses] == [k for k, _ in jr.losses]
    np.testing.assert_allclose(tl, jl, rtol=rtol_loss)
    np.testing.assert_allclose(tr.state.params["w"].numpy(),
                               np.asarray(jr.state.params["w"]), rtol=0,
                               atol=atol_params)


@pytest.mark.parametrize("mode", ["scan", "host"])
@pytest.mark.parametrize("name,transport", CODECS)
def test_run_l2gd_logreg_quickstart(name, transport, mode):
    """The quickstart's configuration: 5 heterogeneous clients, d = 124,
    eta 0.5, lambda 1, p 0.3, PRNGKey(0), 500 steps."""
    (X, Y), (TX, TY), jgrad, tgrad = _logreg_problem()
    n, steps = 5, 500
    (jup, jdown), (tup, tdown) = _plans(name, transport,
                                        {"w": jnp.zeros(124)},
                                        {"w": torch.zeros(124)})
    jplan_arg = None if transport is None else jup
    tplan_arg = None if transport is None else tup
    jr = jrun(jax.random.PRNGKey(0), {"w": jnp.zeros((n, 124))}, jgrad,
              JHyper(eta=0.5, lam=1.0, p=0.3, n=n), lambda k: (X, Y), steps,
              client_comp=jdown, master_comp=jdown, plan=jplan_arg, mode=mode)
    tr = run_l2gd(prng.PRNGKey(0), {"w": torch.zeros(n, 124)}, tgrad,
                  L2GDHyper(eta=0.5, lam=1.0, p=0.3, n=n), lambda k: (TX, TY),
                  steps, client_comp=tdown, master_comp=tdown, plan=tplan_arg,
                  mode=mode, device="cpu")
    w = np.asarray(jr.state.params["w"])
    if name == "identity":
        _check_run(jr, tr, atol_params=1e-5, rtol_loss=1e-5)
    else:
        _check_run(jr, tr, np.sqrt(np.sum(np.mean(w, 0) ** 2)) / 127,
                   rtol_loss=QSGD_LOSS_RTOL)
    assert tr.losses[-1][1] < tr.losses[0][1]


@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("name,transport", CODECS)
def test_run_l2gd_quadratic(name, transport, forced):
    """The quadratic fixture with per-step batches, an eval_fn and
    LoCoDL local steps; keyed and forced-xi realizations."""
    n, d, steps = 4, 12, 60
    base = np.array(quad_batch(n, d))
    (jup, jdown), (tup, tdown) = _plans(name, transport, {"w": jnp.zeros(d)},
                                        {"w": torch.zeros(d)})
    xi = (np.arange(steps) % 3 != 0).astype(np.int32) if forced else None
    jb = [jnp.asarray(base * (1 + 0.01 * k)) for k in range(steps)]
    tb = [torch.from_numpy((base * (1 + 0.01 * k)).astype(np.float32))
          for k in range(steps)]
    jr = jrun(jax.random.PRNGKey(3), {"w": jnp.zeros((n, d))}, quad_grad_fn,
              JHyper(eta=0.2, lam=0.5, p=0.4, n=n), lambda k: jb[k], steps,
              client_comp=jdown, master_comp=jdown,
              plan=None if transport is None else jup, xi_trace=xi,
              eval_fn=lambda p: jnp.sum(p["w"]), eval_every=20,
              local_steps=2)
    tr = run_l2gd(prng.PRNGKey(3), {"w": torch.zeros(n, d)}, _quad_torch,
                  L2GDHyper(eta=0.2, lam=0.5, p=0.4, n=n), lambda k: tb[k],
                  steps, client_comp=tdown, master_comp=tdown,
                  plan=None if transport is None else tup, xi_trace=xi,
                  eval_fn=lambda p: torch.sum(p["w"]), eval_every=20,
                  local_steps=2, device="cpu")
    atol = 1e-5 if name == "identity" else \
        np.abs(base).max() * np.sqrt(d) / 127
    _check_run(jr, tr, atol, rtol_loss=1e-4 if name == "identity"
               else QSGD_LOSS_RTOL)
    assert [k for k, _ in tr.evals] == [k for k, _ in jr.evals] == [20, 40, 60]
    np.testing.assert_allclose([v for _, v in tr.evals],
                               [v for _, v in jr.evals], rtol=1e-3,
                               atol=atol * n * d)


@pytest.mark.parametrize("chunk", [None, 1, 7])
def test_scan_chunks_equal_host_loop(chunk):
    """The port's chunked rollout and its per-step loop are one
    computation: identical params, losses and ledgers, any chunking."""
    (_, _), (TX, TY), _, tgrad = _logreg_problem()
    kw = dict(client_comp=make_compressor("qsgd"),
              master_comp=make_compressor("qsgd"), device="cpu")
    hp = L2GDHyper(eta=0.5, lam=1.0, p=0.3, n=5)
    runs = [run_l2gd(prng.PRNGKey(1), {"w": torch.zeros(5, 124)}, tgrad, hp,
                     lambda k: (TX, TY), 50, mode=mode, chunk=chunk, **kw)
            for mode in ("scan", "host")]
    assert torch.equal(runs[0].state.params["w"], runs[1].state.params["w"])
    assert runs[0].losses == runs[1].losses
    assert runs[0].ledger == runs[1].ledger


def test_run_l2gd_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_l2gd(prng.PRNGKey(0), {"w": torch.zeros(2, 3)}, _quad_torch,
                 L2GDHyper(eta=0.1, lam=1.0, p=0.5, n=2),
                 lambda k: torch.zeros(2, 3), 2)


@pytest.mark.parametrize("option", ["checkpoint_policy", "resume_from"])
def test_unported_driver_options_raise(option, tmp_path):
    """The checkpoint options are ported (tests/test_torch_resume.py);
    like the reference's, they raise in the host loop, which has no
    chunk boundaries."""
    from repro_torch.checkpoint import CheckpointPolicy
    value = CheckpointPolicy(str(tmp_path)) \
        if option == "checkpoint_policy" else str(tmp_path)
    with pytest.raises(ValueError, match="scan"):
        run_l2gd(prng.PRNGKey(0), {"w": torch.zeros(2, 3)}, _quad_torch,
                 L2GDHyper(eta=0.1, lam=1.0, p=0.5, n=2),
                 lambda k: torch.zeros(2, 3), 2, device="cpu", mode="host",
                 **{option: value})


def test_port_loads_no_jax_and_no_reference():
    """Importing the port and running it on the CPU loads neither jax nor
    any module of the JAX package."""
    code = textwrap.dedent("""
        import sys
        import torch
        import repro_torch
        from repro_torch.core import L2GDHyper, make_compressor, prng
        from repro_torch.data import logreg_loss_and_grad, make_logreg_data
        from repro_torch.fl import run_l2gd
        import repro_torch.configs, repro_torch.data.tokens, repro_torch.launch.steps
        import repro_torch.models, repro_torch.kernels.flash_attention.ops
        data = make_logreg_data(n_clients=3, m_per_client=20, seed=0)
        X, Y = torch.from_numpy(data.features), torch.from_numpy(data.labels)
        def grad_fn(p, b):
            loss, g = logreg_loss_and_grad(p["w"], b[0], b[1])
            return loss, {"w": g}
        q = make_compressor("qsgd")
        run = run_l2gd(prng.PRNGKey(0), {"w": torch.zeros(3, 124)}, grad_fn,
                       L2GDHyper(eta=0.5, lam=1.0, p=0.3, n=3),
                       lambda k: (X, Y), 20, client_comp=q, master_comp=q,
                       device="cpu")
        assert run.ledger.rounds > 0
        import repro_torch.optim, repro_torch.core.theory
        import repro_torch.core.extensions, repro_torch.data.partition
        import repro_torch.configs.logreg_a1a
        from repro_torch.fl import (FaultPlan, geometric_latency_probs,
                                    run_fedavg, run_fedopt)
        faults = FaultPlan(max_delay=2, drop_rate=0.2, quorum=0.5,
                           latency_probs=geometric_latency_probs(1.0, 3))
        run = run_l2gd(prng.PRNGKey(0), {"w": torch.zeros(3, 124)}, grad_fn,
                       L2GDHyper(eta=0.5, lam=1.0, p=0.3, n=3),
                       lambda k: (X, Y), 20, client_comp=q, master_comp=q,
                       participation=0.7, faults=faults, device="cpu")
        assert run.fault_stats["sent"] > 0
        fed = run_fedavg(prng.PRNGKey(1), {"w": torch.zeros(124)}, grad_fn,
                         lambda r, i: [(X[i], Y[i])], 3, 4, 0.3,
                         compressor=q, device="cpu")
        assert fed.ledger.rounds == 4
        run_fedopt(prng.PRNGKey(1), {"w": torch.zeros(124)}, grad_fn,
                   lambda r, i: [(X[i], Y[i])], 3, 2, 0.3, device="cpu")
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "repro" or m.startswith("repro."))
        print("LOADED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LOADED []" in out.stdout
