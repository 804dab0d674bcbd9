"""The port's 2-D (clients x model) training engine and
``remat_policy="dots"`` against the port's stacked builders and the JAX
reference, on a tiny stablelm-1.6b (2 layers, d_model 64, vocab 256) with
the reference's ``init_params`` weights carried across.

  * the (1, 1) mesh keystone (tests/test_mesh2d.py:284): params, cache,
    losses and xis equal the port's ``build_rollout_fn`` bit for bit;
    against the reference's ``build_rollout_fn`` the xis, branches and
    counts are exact and the params within PARAM_RTOL of each leaf's
    largest magnitude (tests/test_torch_train.py's bound: XLA contracts
    multiply-adds into FMAs and sums the products in another order);
  * two model shards and two client rows on two gloo processes (one
    spawn): params, cache, losses and xis equal ``build_rollout_fn``'s bit
    for bit — tighter than the reference's rtol 1e-5 / atol 1e-6
    (tests/test_mesh2d.py:326), since each shard computes the whole
    gradient from the gathered leaves;
  * bf16 params with local_steps=2 stay bf16 and finite (:304);
  * ``remat_policy="dots"`` equals "full" and remat off bit for bit and
    ``jax.grad`` within GRAD_RTOL;
  * the train CLI's ``--engine mesh2d`` on the CPU (one process, and two
    spawned processes with two model shards) gives the reference CLI's
    rounds, counts and bits/n.
"""
import dataclasses
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_threads import torch_one_thread  # noqa: F401
import _torch_ranks as ranks
from repro.configs import get_config as jget_config
from repro.core import L2GDHyper as JHyper
from repro.core import init_state as jinit_state
from repro.core import make_compressor as jmake
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro_torch.convert import params_from_numpy
from repro_torch.core import init_state, make_compressor, make_hyper
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data import TokenStream
from repro_torch.launch import steps
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_train_mesh, run_cpu_ranks

N, B, S, LENGTH = 2, 1, 16, 5
PARAM_RTOL = 1e-5
GRAD_RTOL = 2e-5
KEY = 19


def _cfgs(dtype="float32", remat_policy="full"):
    cfg = ranks._tiny_lm(dtype, remat_policy)
    jcfg = dataclasses.replace(
        jget_config("stablelm-1.6b").reduced(), n_layers=2, d_model=64,
        d_ff=128, n_heads=4, n_kv_heads=2, head_dim=16, vocab_size=256,
        param_dtype=dtype, compute_dtype=dtype)
    return cfg, jcfg


def _problem(jcfg):
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    jp = jax.vmap(lambda k: jinit_params(k, jcfg))(keys)
    np_params = jax.tree.map(lambda a: np.array(a, np.float32), jp)
    ts = TokenStream(n_clients=N, vocab=256, batch=B, seq=S, seed=1)
    tokens = np.stack([ts.batch_at(k) for k in range(LENGTH)])
    return jp, np_params, tokens


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-30))


def _key():
    return np.asarray(jax.random.PRNGKey(KEY), np.uint32)


def test_mesh2d_keystone_bit_exact():
    cfg, jcfg = _cfgs(remat_policy="dots")
    jp, np_params, tokens = _problem(jcfg)
    hp = make_hyper(eta=0.1, lam=0.5, p=0.5, n=N)
    kw = dict(client_comp=make_compressor("natural"),
              master_comp=make_compressor("natural"), length=LENGTH)
    batches = {"tokens": torch.from_numpy(tokens)}
    full = dataclasses.replace(cfg, remat_policy="full")
    ref, rtr = steps.build_rollout_fn(full, hp, **kw)(
        init_state(params_from_numpy(np_params)), batches, _key())
    roll = steps.build_sharded_rollout_fn(
        cfg, hp, mesh=make_train_mesh(model_shards=1, device="cpu"), **kw)
    out, otr = roll(init_state(params_from_numpy(np_params)), batches,
                    _key())
    assert set(otr.branches.tolist()) == {0, 1, 2}
    np.testing.assert_array_equal(otr.xis, rtr.xis)
    assert torch.equal(otr.losses, rtr.losses)
    for a, b in zip(tree_leaves((out.params, out.cache)),
                    tree_leaves((ref.params, ref.cache))):
        assert torch.equal(a, b)
    # the reference's build_rollout_fn (its (1, 1) keystone's other side)
    jhp = JHyper(eta=jnp.asarray(0.1, jnp.float32),
                 lam=jnp.asarray(0.5, jnp.float32),
                 p=jnp.asarray(0.5, jnp.float32), n=N)
    jst, jtr = jsteps.build_rollout_fn(
        jcfg, jhp, jmake("natural"), jmake("natural"), length=LENGTH,
        donate=False)(jinit_state(jp), {"tokens": jnp.asarray(tokens)},
                      jax.random.key_data(jax.random.PRNGKey(KEY)))
    np.testing.assert_array_equal(otr.xis, np.asarray(jtr.xis))
    np.testing.assert_array_equal(otr.branches, np.asarray(jtr.branches))
    np.testing.assert_allclose(otr.losses.numpy(), np.asarray(jtr.losses),
                               rtol=1e-5)
    for got, want in zip(tree_leaves(out.params),
                         jax.tree.leaves(jst.params)):
        assert _rel(got.numpy(), want) <= PARAM_RTOL


def test_mesh2d_two_processes_bit_exact():
    _, jcfg = _cfgs()
    _, np_params, tokens = _problem(jcfg)
    r0, r1 = run_cpu_ranks(ranks.mesh2d_rollouts, 2, np_params, tokens,
                           _key())
    for r in (r0, r1):
        assert set(r["ref_xis"].tolist()) == {0, 1}
        for shape in ((1, 2), (2, 1)):
            got = r[shape]
            np.testing.assert_array_equal(got["xis"], r["ref_xis"])
            np.testing.assert_array_equal(got["losses"], r["ref_losses"])
            for a, b in zip(got["params"] + got["cache"],
                            r["ref_params"] + r["ref_cache"]):
                np.testing.assert_array_equal(a, b)
    # each process held its block: (1, 2) halves the sharded dims
    full = [a.shape for a in r0["ref_params"]]
    local = r0[(1, 2)]["local_shapes"]
    assert local != full and all(np.prod(l) * 2 in (np.prod(f),
                                                     2 * np.prod(f))
                                 for l, f in zip(local, full))
    assert r0[(2, 1)]["local_shapes"] == [(1,) + f[1:] for f in full]
    # the sharding helpers: the table's vocab rows cut in two
    assert r0["table_spec"] == ("clients", "model", None)
    assert r0["placements"][1] == "Shard(dim=1)"
    np.testing.assert_array_equal(
        np.concatenate([r0["table_local"], r1["table_local"]], axis=1),
        np_params["embed"]["table"])
    assert r0["state_local_shapes"] == local
    assert r0["batch_local_shape"] == tokens.shape


def test_mesh2d_bf16_local_steps():
    cfg, jcfg = _cfgs("bfloat16")
    _, np_params, tokens = _problem(jcfg)
    hp = make_hyper(eta=0.1, lam=0.5, p=0.5, n=N)
    roll = steps.build_sharded_rollout_fn(
        cfg, hp, mesh=make_train_mesh(model_shards=1, device="cpu"),
        client_comp=make_compressor("natural"),
        master_comp=make_compressor("natural"), length=3, local_steps=2)
    params = tree_map(lambda a: a.to(torch.bfloat16),
                      params_from_numpy(np_params))
    final, trace = roll(init_state(params),
                        {"tokens": torch.from_numpy(tokens[:3])}, _key())
    assert all(a.dtype == torch.bfloat16 for a in tree_leaves(final.params))
    assert np.all(np.isfinite(trace.losses.numpy()))
    assert trace.n_local + trace.n_agg_comm + trace.n_agg_cached == 3


def test_remat_dots_equals_full_off_and_jax_grad():
    _, jcfg = _cfgs()
    jp, np_params, tokens = _problem(jcfg)
    tp = params_from_numpy(np_params)
    batch = {"tokens": torch.from_numpy(tokens[0])}
    grads = {}
    for policy in ("dots", "full", "off"):
        cfg, _ = _cfgs(remat_policy="full" if policy == "off" else policy)
        cfg = dataclasses.replace(cfg, remat=policy != "off")
        grads[policy] = steps.stacked_grad_fn(cfg)(tp, batch)
    for other in ("full", "off"):
        assert torch.equal(grads["dots"][0], grads[other][0])
        for a, b in zip(tree_leaves(grads["dots"][1]),
                        tree_leaves(grads[other][1])):
            assert torch.equal(a, b)

    def one(p, t):
        (loss, _), g = jax.value_and_grad(
            lambda q: jloss_fn(q, jcfg, {"tokens": t}), has_aux=True)(p)
        return loss, g

    _, jg = jax.jit(jax.vmap(one))(jp, jnp.asarray(tokens[0]))
    for got, want in zip(tree_leaves(grads["dots"][1]), jax.tree.leaves(jg)):
        for i in range(N):
            assert _rel(got[i].numpy(), np.asarray(want[i])) <= GRAD_RTOL


CLI = ["--clients", "2", "--batch", "1", "--seq", "16", "--steps", "6",
       "--layers", "1", "--d-model", "64", "--heads", "2", "--kv-heads", "2",
       "--d-ff", "128", "--vocab", "128", "--log-every", "2",
       "--engine", "mesh2d", "--p", "0.5", "--compressor", "qsgd"]
_PROTOCOL = re.compile(r"rounds=(\d+)\s+bits/n=(\S+)\s+local=(\d+) "
                       r"aggC=(\d+) aggK=(\d+)")


def test_train_cli_mesh2d_matches_reference_cli(capsys):
    jtrain.main(CLI)
    want = _PROTOCOL.search(capsys.readouterr().out)
    run = ttrain.main(CLI, device="cpu")
    got = _PROTOCOL.search(capsys.readouterr().out)
    assert want and got and got.groups() == want.groups()
    rounds, local, fresh, cached = (int(want[i]) for i in (1, 3, 4, 5))
    assert (run.ledger.rounds, run.trace.n_local, run.trace.n_agg_comm,
            run.trace.n_agg_cached) == (rounds, local, fresh, cached)
    assert fresh >= 1
    # two spawned processes, two model shards: the same protocol
    per_rank = ttrain.main(CLI + ["--model-shards", "2", "--clients", "2",
                                  "--cpu-ranks", "2"])
    for xis, r, bits, nl, nc, nk in per_rank:
        np.testing.assert_array_equal(xis, run.trace.xis)
        assert (r, nl, nc, nk) == (rounds, local, fresh, cached)
        assert bits == run.ledger.bits_per_client
    assert f"{run.ledger.bits_per_client:.3e}" == want[2]


def test_train_cli_mesh2d_refuses_checkpoint_manager(tmp_path):
    with pytest.raises(SystemExit):
        ttrain.main(CLI + ["--ckpt", str(tmp_path), "--ckpt-every", "1"],
                    device="cpu")
    with pytest.raises(ValueError, match="needs 2 processes"):
        ttrain.main(CLI + ["--model-shards", "2"], device="cpu")
