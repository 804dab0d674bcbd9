"""Parity of the port's LM training path with the JAX reference, on
reduced stablelm-1.6b (2 layers, d_model 256, vocab 512) with the
reference's ``init_params`` weights carried across
(``convert.params_from_numpy``) and the token stream's batches: the
model's gradient, remat, ``build_train_step`` and ``build_rollout_fn``
with leafwise natural and QSGD compression both ways, exact ``round_bits``
of full-size stablelm-1.6b, the train CLI, and no jax on the path.

The reference runs jitted, its hypers as float32 arrays (as its driver
passes them), its step built with ``donate=False`` and jitted once.  Bounds (float32, measured
here with jax 0.9.0 and torch 2.13 on the CPU):

  * GRAD_RTOL: gradients relative to each leaf's largest magnitude — the
    frameworks' matrix products sum in other orders (the logits agree
    within 2e-5, tests/test_torch_lm.py);
  * LOSS_RTOL: per-step losses, relative;
  * PARAM_RTOL: params after 5 steps, relative to each leaf's largest
    magnitude; a compression decision that flips on an ulp-level
    difference would move one element by a whole rounding step, and the
    test would show it (none does at these seeds).
The protocol realization (xi trace, branches, counts, the bits ledger) is
exact.
"""
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_threads import torch_one_thread  # noqa: F401
from repro.configs import get_config as jget_config
from repro.core import L2GDHyper as JHyper
from repro.core import codec as jcodec
from repro.core import compressors as jcomp
from repro.core import init_state as jinit_state
from repro.fl.ledger import BitsLedger as JLedger
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import L2GDHyper, init_state, make_compressor, prng
from repro_torch.core.codec import make_plan
from repro_torch.core.l2gd import l2gd_step
from repro_torch.core.rollout import window_streams
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data import TokenStream
from repro_torch.fl.ledger import BitsLedger
from repro_torch.launch import steps
from repro_torch.launch import train as ttrain
from repro_torch.models import init_params

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
GRAD_RTOL = 2e-5
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-5
N, B, S = 2, 2, 16
XI = [0, 1, 1, 0, 1]
ETA, LAM, P = 0.1, 0.5, 0.2          # the train CLI's defaults
STABLELM_PARAMS = 1_438_746_624


def _cfgs(**changes):
    cfg = dataclasses.replace(get_config("stablelm-1.6b").reduced(),
                              **changes)
    jcfg = dataclasses.replace(jget_config("stablelm-1.6b").reduced(),
                               **changes)
    return cfg, jcfg


def _stacked(jcfg, n=N, seed=0):
    """(reference stacked params, the same carried across)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    jp = jax.vmap(lambda k: jinit_params(k, jcfg))(keys)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _batch(step, vocab=512, n=N):
    return TokenStream(n_clients=n, vocab=vocab, batch=B, seq=S,
                       seed=1).batch_at(step)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-30))


def _hypers(p=P):
    """The port's hypers and the reference's, the latter as float32
    arrays so that both form the step scalings in float32."""
    return (L2GDHyper(eta=ETA, lam=LAM, p=p, n=N),
            JHyper(eta=jnp.asarray(ETA, jnp.float32),
                   lam=jnp.asarray(LAM, jnp.float32),
                   p=jnp.asarray(p, jnp.float32), n=N))


# --------------------------------------------------------------------------
# the model's gradient
# --------------------------------------------------------------------------

def test_grad_fn_matches_jax_grad():
    cfg, jcfg = _cfgs()
    jp, tp = _stacked(jcfg)
    tokens = _batch(0)

    def one(p, t):
        (loss, _), g = jax.value_and_grad(
            lambda q: jloss_fn(q, jcfg, {"tokens": t}), has_aux=True)(p)
        return loss, g

    jl, jg = jax.jit(jax.vmap(one))(jp, jnp.asarray(tokens))
    tl, tg = steps.stacked_grad_fn(cfg)(tp, {"tokens":
                                             torch.from_numpy(tokens)})
    assert _rel(tl.numpy(), jl) <= LOSS_RTOL
    for got, want in zip(tree_leaves(tg), jax.tree.leaves(jg)):
        assert got.shape == want.shape
        for i in range(N):
            assert _rel(got[i].numpy(), np.asarray(want[i])) <= GRAD_RTOL
    # the loss-only route gives the gradient route's losses
    losses = steps.stacked_loss_fn(cfg)(tp, {"tokens":
                                             torch.from_numpy(tokens)})
    assert torch.equal(losses, tl)


def test_remat_on_equals_remat_off():
    cfg, jcfg = _cfgs()
    _, tp = _stacked(jcfg)
    batch = {"tokens": torch.from_numpy(_batch(2))}
    off = steps.stacked_grad_fn(dataclasses.replace(cfg, remat=False))(
        tp, batch)
    on = steps.stacked_grad_fn(dataclasses.replace(cfg, remat=True))(
        tp, batch)
    assert torch.equal(off[0], on[0])
    for a, b in zip(tree_leaves(off[1]), tree_leaves(on[1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_stacked_grad_fn_equals_autograd_of_the_stacks(arch):
    """The per-layer leaves and the hooks that copy each gradient into
    the stacked tensor give autograd's bits for the stacked leaves, with
    remat off, "full" and "dots" (reduced configs, random weights)."""
    from repro_torch.core.tree import tree_flatten, tree_unflatten
    from repro_torch.launch.train import batch_fn, init_stacked_params
    from repro_torch.models import loss_fn as model_loss
    base = get_config(arch).reduced()
    stream = TokenStream(n_clients=2, vocab=base.vocab_size, batch=1,
                         seq=16)
    batch = {k: torch.as_tensor(v) for k, v in
             batch_fn(base, stream, 0, torch.device("cpu"))(0).items()}
    params = init_stacked_params(base, 2, 0, torch.device("cpu"))
    leaves, treedef = tree_flatten(params)
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        cfg = dataclasses.replace(base, remat=remat, remat_policy=policy)
        losses, grads = steps.stacked_grad_fn(cfg)(params, batch)
        for i in range(2):
            own = [a[i].detach().requires_grad_() for a in leaves]
            loss, _ = model_loss(tree_unflatten(treedef, own), cfg,
                                 {k: v[i] for k, v in batch.items()})
            want = torch.autograd.grad(loss, own)
            assert torch.equal(losses[i], loss.detach())
            for w, g in zip(want, tree_leaves(grads)):
                assert torch.equal(g[i], w)


def test_remat_checkpoints_each_layer(monkeypatch):
    from repro_torch.models import model as tmodel
    cfg, jcfg = _cfgs(remat=True)
    _, tp = _stacked(jcfg)
    calls = []
    real = tmodel.checkpoint

    def spy(fn, *args, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(fn, *args, **kw)

    monkeypatch.setattr(tmodel, "checkpoint", spy)
    batch = {"tokens": torch.from_numpy(_batch(0))}
    steps.stacked_loss_fn(cfg)(tp, batch)          # no backward: no remat
    assert calls == []
    steps.stacked_grad_fn(cfg)(tp, batch)
    assert calls == [False] * (cfg.n_layers * N)


def test_unported_training_options_raise():
    """The options the multi-device slice ported no longer raise:
    remat_policy="dots" gives remat "full"'s gradient bit for bit, and
    build_train_step's average_fn replaces the fresh branch's
    aggregation (tests/test_torch_mesh.py holds a shard average there)."""
    cfg, jcfg = _cfgs(remat=True, remat_policy="dots")
    _, tp = _stacked(jcfg)
    batch = {"tokens": torch.from_numpy(_batch(0))}
    dots = steps.stacked_grad_fn(cfg)(tp, batch)
    full = steps.stacked_grad_fn(dataclasses.replace(
        cfg, remat_policy="full"))(tp, batch)
    for a, b in zip(tree_leaves(dots), tree_leaves(full)):
        assert torch.equal(a, b)
    hp = L2GDHyper(eta=ETA, lam=LAM, p=P, n=N)
    calls = []

    def average_fn(key, params):
        calls.append(key)
        return tree_map(lambda a: a[0].clone(), params)

    step = steps.build_train_step(cfg, hp, average_fn=average_fn)
    state, metrics = step(init_state(tp)._replace(xi_prev=0), batch, 1,
                          prng.PRNGKey(0))
    assert metrics["branch"] == 1 and len(calls) == 1
    for a, b in zip(tree_leaves(state.cache), tree_leaves(tp)):
        assert torch.equal(a, b[0])
    # a per-client plan vector (a fleet) builds since the fleet slice
    steps.build_train_step(cfg, hp, [make_compressor("qsgd")] * N)


def test_aggregation_branches_skip_the_backward():
    cfg, jcfg = _cfgs()
    _, tp = _stacked(jcfg)
    batch = {"tokens": torch.from_numpy(_batch(0))}
    grad_fn, loss_fn = steps.stacked_grad_fn(cfg), steps.stacked_loss_fn(cfg)
    called = []

    def spy(p, b):
        called.append(1)
        return grad_fn(p, b)

    hp = L2GDHyper(eta=ETA, lam=LAM, p=P, n=N)
    state = init_state(tp)
    key = prng.PRNGKey(0)
    for xi, branch in ((1, 2), (0, 0), (1, 1)):
        with_loss, m1 = l2gd_step(state, batch, xi, key, spy, hp,
                                  loss_fn=loss_fn)
        plain, m2 = l2gd_step(state, batch, xi, key, grad_fn, hp)
        assert m1["branch"] == m2["branch"] == branch
        assert torch.equal(m1["loss"], m2["loss"])
        for a, b in zip(tree_leaves(with_loss.params),
                        tree_leaves(plain.params)):
            assert torch.equal(a, b)
        state = with_loss
    assert len(called) == 1           # the local step only


# --------------------------------------------------------------------------
# the step builders against the reference's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["natural", "qsgd"])
def test_build_train_step_matches_reference(name):
    cfg, jcfg = _cfgs()
    jp, tp = _stacked(jcfg)
    hp, jhp = _hypers()
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


@pytest.mark.parametrize("name", ["natural", "qsgd"])
def test_build_rollout_fn_matches_reference(name):
    cfg, jcfg = _cfgs()
    jp, tp = _stacked(jcfg, seed=3)
    hp, jhp = _hypers(p=0.5)
    length = 6
    tokens = np.stack([_batch(k) for k in range(length)])
    jroll = jsteps.build_rollout_fn(jcfg, jhp, jcomp.make_compressor(name),
                                    jcomp.make_compressor(name),
                                    length=length, donate=False)
    troll = steps.build_rollout_fn(cfg, hp, make_compressor(name),
                                   make_compressor(name), length=length)
    key = jax.random.PRNGKey(11)
    jstate, jtrace = jroll(jinit_state(jp), {"tokens": jnp.asarray(tokens)},
                           jax.random.key_data(key))
    tstate, ttrace = troll(init_state(tp),
                           {"tokens": torch.from_numpy(tokens)},
                           np.asarray(key))
    np.testing.assert_array_equal(ttrace.xis, np.asarray(jtrace.xis))
    np.testing.assert_array_equal(ttrace.branches,
                                  np.asarray(jtrace.branches))
    assert (ttrace.n_local, ttrace.n_agg_comm, ttrace.n_agg_cached) == \
        (int(jtrace.n_local), int(jtrace.n_agg_comm),
         int(jtrace.n_agg_cached))
    assert ttrace.n_agg_comm >= 1
    up = make_plan(make_compressor(name), steps.param_shapes(cfg),
                   transport="leafwise").round_bits()
    jup = jcodec.make_plan(jcomp.make_compressor(name),
                           jsteps.param_shapes(jcfg),
                           transport="leafwise").round_bits()
    ours, theirs = BitsLedger(N), JLedger(N)
    ours.replay_xi_trace(ttrace.xis, up, up)
    theirs.replay_xi_trace(np.asarray(jtrace.xis), jup, jup)
    assert ours.rounds == theirs.rounds == ttrace.n_agg_comm
    assert ours.bits_per_client == theirs.bits_per_client
    np.testing.assert_allclose(ttrace.losses.numpy(),
                               np.asarray(jtrace.losses), rtol=LOSS_RTOL)
    for got, want in zip(tree_leaves(tstate.params),
                         jax.tree.leaves(jstate.params)):
        assert _rel(got.numpy(), want) <= PARAM_RTOL


@pytest.mark.parametrize("name", ["natural", "qsgd"])
def test_full_size_round_bits_equal_reference(name):
    cfg, jcfg = get_config("stablelm-1.6b"), jget_config("stablelm-1.6b")
    shapes = steps.param_shapes(cfg)
    assert sum(a.numel() for a in tree_leaves(shapes)) == STABLELM_PARAMS
    ours = make_plan(make_compressor(name), shapes,
                     transport="leafwise").round_bits()
    theirs = jcodec.make_plan(jcomp.make_compressor(name),
                              jsteps.param_shapes(jcfg),
                              transport="leafwise").round_bits()
    assert ours == theirs
    buckets = sum(-(-a.numel() // 2048) for a in tree_leaves(shapes))
    assert ours == {"natural": 9 * STABLELM_PARAMS,
                    "qsgd": 8 * STABLELM_PARAMS + 32 * buckets}[name]


def test_param_shapes_equal_reference():
    cfg, jcfg = get_config("stablelm-1.6b"), jget_config("stablelm-1.6b")
    ours = [tuple(a.shape) for a in
            tree_leaves(steps.stacked_param_shapes(cfg, 3))]
    theirs = [tuple(s.shape) for s in
              jax.tree.leaves(jsteps.stacked_param_shapes(jcfg, 3))]
    assert ours == theirs
    assert all(a.device.type == "meta" for a in
               tree_leaves(steps.param_shapes(cfg)))


def test_plans_pass_through():
    cfg, _ = _cfgs()
    hp = L2GDHyper(eta=ETA, lam=LAM, p=P, n=N)
    shapes = steps.param_shapes(cfg)
    flat = make_plan(make_compressor("qsgd"), transport="flat")
    assert steps._uplink_plan(flat, shapes).specs is not None
    assert steps._uplink_plan(make_compressor("qsgd"), shapes).transport \
        == "leafwise"
    steps.build_train_step(cfg, hp, plans=(flat.bind(shapes),
                                           flat.bind(shapes)))


# --------------------------------------------------------------------------
# the train CLI
# --------------------------------------------------------------------------

CLI = ["--clients", "2", "--batch", "2", "--seq", "16", "--steps", "6",
       "--layers", "1", "--d-model", "64", "--heads", "2", "--kv-heads", "2",
       "--d-ff", "128", "--vocab", "128", "--log-every", "2"]


@pytest.mark.parametrize("name", ["natural", "qsgd", "topk"])
def test_train_cli_runs_on_the_cpu(name, capsys):
    run = ttrain.main(CLI + ["--compressor", name], device="cpu")
    out = capsys.readouterr().out
    assert "params/client=" in out and "final loss" in out
    assert f"rounds={run.ledger.rounds}" in out
    assert run.n_local + run.n_agg_comm + run.n_agg_cached == 6
    assert all(np.isfinite(v) for _, v in run.losses)
    # auto plans, as the reference's CLI: one message a round each way
    cfg = ttrain.build(get_config("stablelm-1.6b").reduced(), {
        "n_layers": 1, "d_model": 64, "d_ff": 128, "n_heads": 2,
        "n_kv_heads": 2, "vocab_size": 128, "head_dim": None})
    bits = make_plan(make_compressor(name),
                     steps.param_shapes(cfg)).round_bits()
    assert run.ledger.bits_per_client == 2 * bits * run.ledger.rounds


_PROTOCOL = re.compile(r"rounds=(\d+)\s+bits/n=(\S+)\s+local=(\d+) "
                       r"aggC=(\d+) aggK=(\d+)")


def test_train_cli_draws_the_reference_protocol(capsys):
    """The same flags give the reference's CLI and the port's the same
    protocol: xi trace, rounds, local / fresh / cached counts and bits/n.
    The reference folds its deprecated ``seed=`` (seed + 4) into the key
    seed + 3; at 16 steps a key without the fold draws another trace
    (4 rounds against the reference's 3)."""
    argv = CLI + ["--steps", "16", "--compressor", "qsgd"]
    with pytest.warns(DeprecationWarning, match="seed="):
        jtrain.main(argv)
    want = _PROTOCOL.search(capsys.readouterr().out)
    run = ttrain.main(argv, device="cpu")
    got = _PROTOCOL.search(capsys.readouterr().out)
    assert want and got and got.groups() == want.groups()
    assert (run.ledger.rounds, run.n_local, run.n_agg_comm,
            run.n_agg_cached) == tuple(int(want[i]) for i in (1, 3, 4, 5))


@pytest.mark.parametrize("extra", [["--engine", "mesh2d"],
                                   ["--ckpt-every", "1"],
                                   ["--resume", "--ckpt", "x"]])
def test_train_cli_refuses_unported_engines(extra, tmp_path, monkeypatch):
    """The CLI refuses what the reference's CLI refuses: mesh2d (ported
    since the multi-device slice; tests/test_torch_mesh2d.py) with the
    checkpoint manager's flags, --ckpt-every without --ckpt, --resume
    from an empty root (tests/test_torch_resume.py)."""
    monkeypatch.chdir(tmp_path)
    if extra[0] == "--engine":
        run = ttrain.main(CLI + extra, device="cpu")
        assert run.trace.n_local + run.trace.n_agg_comm \
            + run.trace.n_agg_cached == 6
        with pytest.raises(SystemExit):
            ttrain.main(CLI + extra + ["--ckpt", "x", "--ckpt-every", "1"],
                        device="cpu")
    elif extra[0] == "--ckpt-every":
        with pytest.raises(SystemExit):
            ttrain.main(CLI + extra, device="cpu")
    else:
        with pytest.raises(FileNotFoundError, match="no complete checkpoint"):
            ttrain.main(CLI + extra, device="cpu")


def test_init_stacked_params_is_per_client_init():
    cfg, _ = _cfgs(n_layers=1)
    stacked = ttrain.init_stacked_params(cfg, 2, 5, "cpu")
    for i in range(2):
        own = init_params(torch.Generator().manual_seed(5 + i), cfg,
                          device="cpu")
        for a, b in zip(tree_leaves(stacked), tree_leaves(own)):
            assert torch.equal(a[i], b)


def test_train_path_loads_no_jax_and_no_reference():
    """The train CLI of each ported family (dense GQA, Mamba, hybrid) and
    the mesh path (the mesh2d engine, a shard average, the dry run)."""
    code = (
        "import sys\n"
        "from repro_torch.launch.train import main\n"
        "for arch in ('stablelm-1.6b', 'falcon-mamba-7b', 'hymba-1.5b'):\n"
        "    main(" + repr(CLI + ["--compressor", "qsgd"])
        + " + ['--arch', arch], device='cpu')\n"
        # the mesh path: the 2-D engine through the CLI, the sharded
        # averages, the dry run
        "main(" + repr(CLI + ["--compressor", "natural", "--engine",
                              "mesh2d"]) + ", device='cpu')\n"
        "import torch\n"
        "from repro_torch.core import make_compressor, make_plan\n"
        "from repro_torch.launch import dryrun, mesh, steps\n"
        "m = mesh.make_client_mesh(1, device='cpu')\n"
        "plan = make_plan(make_compressor('qsgd'), {'w': torch.zeros(8)},"
        " transport='packed')\n"
        "steps.build_average_fn(m, ('clients',), {'w': ('clients', None)},"
        " make_compressor('natural'), uplink=plan)(\n"
        "    [0, 1], {'w': torch.ones(2, 8)})\n"
        "dryrun.dry_run('mistral-large-123b', 'train_4k')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LOADED []" in out.stdout
