"""Parity of the port's Mamba and hybrid training path with the JAX
reference, on reduced falcon-mamba-7b and hymba-1.5b (``reduced()``: 2
layers, d_model 256, vocab 512, ``scan_chunk`` 4) with the reference's
``init_params`` weights carried across (``convert.params_from_numpy``)
and the token stream's batches: the model's gradient through the CPU
route (the chunked scan under autograd, as the reference differentiates
it with XLA) and through the kernel route (the scan op's autograd
Function, whose plain forward and backward stand in for the CUDA
kernels here), remat, ``build_train_step`` with leafwise natural and
QSGD compression both ways, and the train CLI against the reference's.

The reference runs jitted, its hypers as float32 arrays, its step built
with ``donate=False`` and jitted once.  The bounds are tests/test_torch_train.py's (float32,
measured here with jax 0.9.0 and torch 2.13 on the CPU): GRAD_RTOL for
gradients relative to each leaf's largest magnitude, LOSS_RTOL for
losses, PARAM_RTOL for params and the cache after 5 steps.  The
protocol realization (branches, rounds, counts, bits) is exact.
"""
import dataclasses
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_threads import torch_one_thread  # noqa: F401
from repro.configs import get_config as jget_config
from repro.core import L2GDHyper as JHyper
from repro.core import compressors as jcomp
from repro.core import init_state as jinit_state
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import L2GDHyper, init_state, make_compressor, prng
from repro_torch.core.rollout import window_streams
from repro_torch.core.tree import tree_leaves
from repro_torch.data import TokenStream
from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.kernels.selective_scan.kernel import selective_scan
from repro_torch.launch import steps
from repro_torch.launch import train as ttrain
from repro_torch.models import mamba as mb

GRAD_RTOL = 2e-5
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-5
N, B, S = 2, 2, 16
XI = [0, 1, 1, 0, 1]
ETA, LAM, P = 0.1, 0.5, 0.2          # the train CLI's defaults
ARCHS = ("falcon-mamba-7b", "hymba-1.5b")


def _cfgs(arch, **changes):
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **changes)
    return cfg, jcfg


def _stacked(jcfg, seed=0):
    """(reference stacked params, the same carried across)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), N)
    jp = jax.vmap(lambda k: jinit_params(k, jcfg))(keys)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _batch(step):
    return TokenStream(n_clients=N, vocab=512, batch=B, seq=S,
                       seed=1).batch_at(step)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-30))


def _jax_grads(jcfg, jp, tokens):
    def one(p, t):
        (loss, _), g = jax.value_and_grad(
            lambda q: jloss_fn(q, jcfg, {"tokens": t}), has_aux=True)(p)
        return loss, g

    return jax.jit(jax.vmap(one))(jp, jnp.asarray(tokens))


def _assert_grads_close(tl, tg, jl, jg):
    assert _rel(tl.numpy(), jl) <= LOSS_RTOL
    for got, want in zip(tree_leaves(tg), jax.tree.leaves(jg)):
        assert got.shape == want.shape
        for i in range(N):
            assert _rel(got[i].numpy(), np.asarray(want[i])) <= GRAD_RTOL


@pytest.fixture
def kernel_route(monkeypatch):
    """The model's scan takes the op, as on the card; on CPU tensors the op
    runs its autograd Function with the plain forward and backward.
    Yields the list of the op's calls."""
    calls = []

    def op(dt, Bm, Cm, x, A):
        calls.append(x.shape)
        return selective_scan(dt.contiguous(), Bm.contiguous(),
                              Cm.contiguous(), x.contiguous(), A)

    monkeypatch.setattr(mb, "use_kernel", lambda *t: True)
    monkeypatch.setattr(scan_ops, "selective_scan_op", op)
    return calls


# --------------------------------------------------------------------------
# the model's gradient
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_grad_fn_matches_jax_grad(arch):
    cfg, jcfg = _cfgs(arch)
    jp, tp = _stacked(jcfg)
    tokens = _batch(0)
    jl, jg = _jax_grads(jcfg, jp, tokens)
    batch = {"tokens": torch.from_numpy(tokens)}
    tl, tg = steps.stacked_grad_fn(cfg)(tp, batch)
    _assert_grads_close(tl, tg, jl, jg)
    assert torch.equal(steps.stacked_loss_fn(cfg)(tp, batch), tl)


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_route_gradient_matches_jax_grad(arch, kernel_route):
    """The scan's autograd Function (the CUDA kernels' route, here their
    plain versions) under remat: the gradient equals remat off bit for
    bit and holds the reference's bound; the scan runs once a layer and
    client without remat, twice with (the recompute)."""
    cfg, jcfg = _cfgs(arch, remat=True)
    jp, tp = _stacked(jcfg, seed=1)
    tokens = _batch(1)
    batch = {"tokens": torch.from_numpy(tokens)}
    off = steps.stacked_grad_fn(dataclasses.replace(cfg, remat=False))(
        tp, batch)
    assert len(kernel_route) == N * cfg.n_layers
    on = steps.stacked_grad_fn(cfg)(tp, batch)
    assert len(kernel_route) == 3 * N * cfg.n_layers
    assert torch.equal(off[0], on[0])
    for a, b in zip(tree_leaves(off[1]), tree_leaves(on[1])):
        assert torch.equal(a, b)
    _assert_grads_close(*on, *_jax_grads(jcfg, jp, tokens))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_equals_remat_off(arch):
    cfg, jcfg = _cfgs(arch)
    _, tp = _stacked(jcfg)
    batch = {"tokens": torch.from_numpy(_batch(2))}
    off = steps.stacked_grad_fn(dataclasses.replace(cfg, remat=False))(
        tp, batch)
    on = steps.stacked_grad_fn(dataclasses.replace(cfg, remat=True))(
        tp, batch)
    assert torch.equal(off[0], on[0])
    for a, b in zip(tree_leaves(off[1]), tree_leaves(on[1])):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the train step against the reference's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,name", [("falcon-mamba-7b", "qsgd"),
                                       ("hymba-1.5b", "natural")])
def test_build_train_step_matches_reference(arch, name):
    """Five forced steps (local, fresh, cached, local, fresh) with
    leafwise compression both ways; each codec on one family (the codecs
    run leaf by leaf whatever the model, tests/test_torch_train.py runs
    both on stablelm-1.6b)."""
    cfg, jcfg = _cfgs(arch)
    jp, tp = _stacked(jcfg)
    hp = L2GDHyper(eta=ETA, lam=LAM, p=P, n=N)
    jhp = JHyper(eta=jnp.asarray(ETA, jnp.float32),
                 lam=jnp.asarray(LAM, jnp.float32),
                 p=jnp.asarray(P, jnp.float32), n=N)
    # jitted once: the un-donated step is a plain function, which eager
    # JAX would trace and compile anew on every call
    jstep = jax.jit(jsteps.build_train_step(
        jcfg, jhp, jcomp.make_compressor(name), jcomp.make_compressor(name),
        donate=False))
    tstep = steps.build_train_step(cfg, hp, make_compressor(name),
                                   make_compressor(name))
    _, keys = window_streams(prng.PRNGKey(0), P, 0, len(XI), XI)
    jstate, tstate = jinit_state(jp), init_state(tp)
    for k, xi in enumerate(XI):
        tokens = _batch(k)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)},
                           jnp.asarray(xi, jnp.int32), jnp.asarray(keys[k]))
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(tokens)}, xi,
                           keys[k])
        assert tm["branch"] == int(jm["branch"]) == [0, 1, 2, 0, 1][k]
        assert abs(float(tm["loss"]) - float(jm["loss"])) \
            <= LOSS_RTOL * abs(float(jm["loss"]))
    assert tstate.xi_prev == int(jstate.xi_prev) and tstate.step == 5
    for tree_t, tree_j in ((tstate.params, jstate.params),
                           (tstate.cache, jstate.cache)):
        for got, want in zip(tree_leaves(tree_t), jax.tree.leaves(tree_j)):
            assert _rel(got.numpy(), want) <= PARAM_RTOL


# --------------------------------------------------------------------------
# the train CLI
# --------------------------------------------------------------------------

CLI = ["--clients", "2", "--batch", "2", "--seq", "16", "--steps", "16",
       "--layers", "1", "--d-model", "64", "--heads", "2", "--kv-heads", "2",
       "--d-ff", "128", "--vocab", "128", "--log-every", "4"]
_PROTOCOL = re.compile(r"rounds=(\d+)\s+bits/n=(\S+)\s+local=(\d+) "
                       r"aggC=(\d+) aggK=(\d+)")


@pytest.mark.parametrize("arch,name", [("falcon-mamba-7b", "qsgd"),
                                       ("hymba-1.5b", "natural")])
def test_train_cli_draws_the_reference_protocol(arch, name, capsys):
    """``--arch`` of either family at the reduced size: the reference's
    CLI and the port's give the same rounds, bits/n and local / fresh /
    cached counts, and the port's losses are finite."""
    argv = CLI + ["--arch", arch, "--compressor", name]
    with pytest.warns(DeprecationWarning, match="seed="):
        jtrain.main(argv)
    want = _PROTOCOL.search(capsys.readouterr().out)
    run = ttrain.main(argv, device="cpu")
    out = capsys.readouterr().out
    got = _PROTOCOL.search(out)
    assert want and got and got.groups() == want.groups()
    assert f"arch={arch} " in out
    assert (run.ledger.rounds, run.n_local, run.n_agg_comm,
            run.n_agg_cached) == tuple(int(want[i]) for i in (1, 3, 4, 5))
    assert run.n_agg_comm >= 1 and run.n_local >= 1
    assert all(np.isfinite(v) for _, v in run.losses)
