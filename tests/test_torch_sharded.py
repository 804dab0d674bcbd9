"""The port's client-sharded engine and per-shard averages
(``repro_torch.core.rollout.rollout_l2gd_sharded``,
``repro_torch.core.aggregation``'s sharded half) against the port's
stacked engine and the JAX reference, on the quadratic fixture
(tests/conftest.py: n = 4 clients, d = 12).

One process (a world of one on gloo, in this process): the sharded run
equals the port's stacked ``rollout_l2gd`` bit for bit (params, cache,
losses, xis), for QSGD and natural on the flat and packed transports, at
full participation and at 0.5, and the mixed fleet too.  Two processes
(``launch.mesh.run_cpu_ranks``, one spawn for all cases): params, cache
and xis bit for bit, every rank's cache the same bits, the losses within
LOSS_ULPS (the reference's psum adds the shards' sums, the stacked mean
adds the clients in order).

Against the reference's own 1-device sharded run the xi trace, branches
and counts are exact; params and cache within PARAM_ULPS ulps of their
largest magnitude (2 measured: XLA:CPU contracts the updates'
multiply-adds into FMAs, the port rounds each product, as
tests/test_torch_l2gd.py states; no QSGD code sits a level away at these
seeds).  The reference's sharded run is itself bit-exact with its
stacked run (tests/test_sharded_rollout.py).

The per-shard averages at two processes against the reference at two
forced host devices, in ONE subprocess for all cases
(tests/_ref_shard_averages.py): natural's packed payload and the bf16
wire (make_sharded_average, compressed_average_wire) bit for bit; packed
QSGD's messages carry the reference's codes bit for bit and its norms
within NORM_ULPS, and its average moves only by those norms' ulps.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from _torch_threads import torch_one_thread  # noqa: F401
import _torch_ranks as ranks
from conftest import quad_batch, quad_grad_fn
from repro.core import init_state as jinit_state
from repro.core import make_compressor as jmake
from repro.core import make_hyper as jmake_hyper
from repro.core import make_plan as jmake_plan
from repro.core import rollout_l2gd_sharded as jsharded
from repro.core.aggregation import make_payload_sharded_average as jpayload
from repro.core.aggregation import stochastic_round_cast as jsrc
from repro.fl.fleet import FleetPlan as JFleetPlan
from repro.launch.mesh import make_client_mesh as jmesh
from repro_torch.core import (init_state, make_compressor, make_hyper,
                              prng)
from repro_torch.core.aggregation import (make_client_sharded_average,
                                          make_payload_sharded_average,
                                          stochastic_round_cast)
from repro_torch.core.l2gd import l2gd_step
from repro_torch.core.rollout import rollout_l2gd_sharded
from repro_torch.launch.mesh import (make_client_mesh, mesh_axis,
                                     run_cpu_ranks)

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
N, D = ranks.N, ranks.D
BATCH = np.array(quad_batch())
XI = [1, 1, 0, 0, 1, 1, 0, 1, 0, 0, 1, 1, 1, 0]
KEY = np.array([0, 1], np.uint32)           # PRNGKey(1)
LOSS_ULPS = 4
PARAM_ULPS = 4
#: packed QSGD's bucket norms against the reference's (1 measured: the
#: sum of squares and its square root rounded in another order)
NORM_ULPS = 2
CASES = [(c, t, part, XI) for c in ("qsgd", "natural")
         for t in ("flat", "packed") for part in (None, 0.5)] \
    + [("fleet", None, None, XI), ("natural", "flat", 0.25, None)]


def _jplan(name, transport):
    return jmake_plan(jmake(name), {"w": jnp.zeros(D)}, transport=transport)


def _jfleet():
    plans = (_jplan("qsgd", "packed"), _jplan("natural", "flat"),
             _jplan("identity", "leafwise"))
    return JFleetPlan(cohorts=plans,
                      assignment=tuple(i % 3 for i in range(N)))


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's 1-device sharded run of every case."""
    out = []
    for name, transport, part, xi in CASES:
        up = _jfleet() if name == "fleet" else _jplan(name, transport)
        down = _jplan("identity", "leafwise") if name == "fleet" else up
        st, tr = jsharded(
            jax.random.PRNGKey(1), jinit_state({"w": jnp.zeros((N, D))}),
            jmake_hyper(eta=0.3, lam=1.0, p=0.5, n=N), jnp.asarray(BATCH),
            None if xi is None else jnp.asarray(xi), mesh=jmesh(1),
            grad_fn=quad_grad_fn, steps=None if xi is not None else 14,
            client_comp=up, master_comp=down, participation=part,
            batch_axis=None)
        out.append({"params": np.asarray(st.params["w"]),
                    "cache": np.asarray(st.cache["w"]),
                    "xis": np.asarray(tr.xis),
                    "branches": np.asarray(tr.branches),
                    "counts": (int(tr.n_local), int(tr.n_agg_comm),
                               int(tr.n_agg_cached))})
    return out


def _against_reference(case, got, want):
    np.testing.assert_array_equal(got["xis"], want["xis"])
    assert tuple(got["counts"]) == want["counts"]
    for k in ("params", "cache"):
        atol = PARAM_ULPS * np.spacing(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.max(np.abs(a.view(np.int32).astype(np.int64)
                             - b.view(np.int32).astype(np.int64))))


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in CASES])
def test_one_rank_equals_stacked_and_reference(i, reference_runs):
    mesh = make_client_mesh(1, device="cpu")
    got = ranks._quad_runs([CASES[i]], torch.from_numpy(BATCH), KEY,
                           mesh)[0]
    for k in ("params", "cache", "losses", "xis"):
        np.testing.assert_array_equal(got[k], got["stacked_" + k])
    _against_reference(CASES[i], got, reference_runs[i])


def test_two_ranks_equal_stacked_and_reference(reference_runs):
    per_rank = run_cpu_ranks(ranks.sharded_quad_rollouts, 2, CASES, BATCH,
                             KEY)
    for i, case in enumerate(CASES):
        r0, r1 = per_rank[0][i], per_rank[1][i]
        params = np.concatenate([r0["params"], r1["params"]])
        np.testing.assert_array_equal(params, r0["stacked_params"])
        np.testing.assert_array_equal(r0["cache"], r0["stacked_cache"])
        np.testing.assert_array_equal(r0["cache"], r1["cache"])
        np.testing.assert_array_equal(r0["losses"], r1["losses"])
        np.testing.assert_array_equal(r0["xis"], r0["stacked_xis"])
        assert _ulps(r0["losses"], r0["stacked_losses"]) <= LOSS_ULPS
        _against_reference(case, {**r0, "params": params},
                           reference_runs[i])


def test_shard_averages_two_ranks_match_reference_two_devices(tmp_path):
    rng = np.random.default_rng(3)
    params = rng.normal(size=(N, 300)).astype(np.float32)
    key = np.array([0, 9], np.uint32)
    np.savez(tmp_path / "in.npz", params=params, key=key)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(os.path.dirname(__file__),
                                      "_ref_shard_averages.py"),
         str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ours = run_cpu_ranks(ranks.shard_averages, 2, params, key)
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, out + err
    want = np.load(tmp_path / "out.npz")
    for k in ("payload_natural", "wire", "wire_one"):
        np.testing.assert_array_equal(ours[0][k], want[k], err_msg=k)
        np.testing.assert_array_equal(ours[1][k], ours[0][k], err_msg=k)
    # packed QSGD: each process's message has the reference's codes bit
    # for bit and its bucket norms within NORM_ULPS; the codes equal,
    # each decoded element (code / levels) x norm moves by at most its
    # norm's difference, and so does the two messages' mean
    codes = np.stack([r["qsgd_codes"] for r in ours])
    norms = np.stack([r["qsgd_norms"] for r in ours])
    np.testing.assert_array_equal(codes, want["qsgd_codes"])
    assert _ulps(norms, want["qsgd_norms"]) <= NORM_ULPS
    np.testing.assert_allclose(
        ours[0]["payload_qsgd"], want["payload_qsgd"], rtol=0,
        atol=NORM_ULPS * np.spacing(np.max(np.abs(want["qsgd_norms"]))))
    # the all_gathers carried the packed payloads: each process's share
    # of the two messages' codes and norms, never float32 values
    plans = [ranks.quad_plan(name, "packed", 300)
             for name in ("qsgd", "natural")]
    assert ours[0]["gathered_bytes"] == \
        sum(2 * p.round_bits() / 8 for p in plans)


def test_payload_sharded_average_single_device():
    """One device / one process: the packed natural payload's average is
    the reference's bit for bit."""
    rng = np.random.default_rng(5)
    w = rng.normal(size=(N, 40)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    jplan = jmake_plan(jmake("natural"), {"w": jnp.zeros(40)},
                       transport="packed")
    jm = jmesh(1)
    with jm:
        want = jax.jit(jpayload(jm, ("clients",), {"w": P("clients", None)},
                                jmake("identity"), jplan))(
            key, {"w": jnp.asarray(w)})["w"]
    mesh = make_client_mesh(1, device="cpu")
    got = make_payload_sharded_average(
        mesh, ("clients",), {"w": ("clients", None)},
        make_compressor("identity"), ranks.quad_plan("natural", "packed", 40))(
        np.asarray(key, np.uint32), {"w": torch.from_numpy(w)})["w"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="whole leaves"):
        make_payload_sharded_average(
            mesh, ("clients",), {"w": ("clients", "model")},
            make_compressor("identity"), ranks.quad_plan("natural", "packed"))


def test_stochastic_round_cast_bit_exact():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(513,)).astype(np.float32) \
        * np.float32(10.0) ** rng.integers(-30, 30, 513).astype(np.float32)
    x[:8] = [np.inf, -np.inf, np.nan, 0.0, -0.0,
             np.finfo(np.float32).max, -np.finfo(np.float32).max,
             np.finfo(np.float32).tiny / 4]
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax.jit(jsrc)(key, jnp.asarray(x)).astype(jnp.float32))
    got = stochastic_round_cast(np.asarray(key, np.uint32),
                                torch.from_numpy(x)).float().numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok].view(np.int32),
                                  want[ok].view(np.int32))
    # unbiased: the mean of many draws approaches x
    keys = prng.split(prng.PRNGKey(1), 400)
    v = torch.full((64,), 1.0 + 2.0 ** -10)
    mean = torch.stack([stochastic_round_cast(k, v).float()
                        for k in keys]).mean()
    assert abs(float(mean) - (1.0 + 2.0 ** -10)) < 2.0 ** -9


def test_sharded_engine_validation():
    mesh = make_client_mesh(1, device="cpu")
    hp = make_hyper(eta=0.3, lam=1.0, p=0.5, n=N)
    kw = dict(mesh=mesh, grad_fn=ranks._quad_grad, steps=2,
              batch_axis=None)
    with pytest.raises(ValueError, match="leading axis"):
        rollout_l2gd_sharded(KEY, init_state({"w": torch.zeros(N + 1, D)}),
                             hp, torch.from_numpy(BATCH), **kw)
    plan = ranks.quad_plan("natural", "flat")
    with pytest.raises(ValueError, match="average_fn"):
        l2gd_step(init_state({"w": torch.zeros(N, D)}),
                  torch.from_numpy(BATCH), 1, KEY, ranks._quad_grad, hp,
                  plan, plan, axis_name=mesh_axis(mesh, "clients"))
    with pytest.raises(ValueError, match="fleet covers"):
        make_client_sharded_average(mesh_axis(mesh, "clients"), N + 1,
                                    ranks.mixed_fleet(), plan)
