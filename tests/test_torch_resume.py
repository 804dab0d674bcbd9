"""Resume keystone of the port (``repro_torch.checkpoint.resume`` and the
driver's ``checkpoint_policy=`` / ``resume_from=``): a run interrupted
at a chunk boundary and resumed from its snapshot equals the
uninterrupted run BIT FOR BIT — params, cache, losses, evals, ledger,
xi trace, counters and fault totals — on the synchronous and async
engines, with and without participation, across codecs, after a real
SIGKILL too.  The port also continues from a snapshot the reference
wrote, within the bound ``tests/test_torch_l2gd.py`` holds the two
trajectories to, its ledger exact.
"""
import os
import signal
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch

from _torch_threads import torch_one_thread  # noqa: F401
from conftest import quad_batch, quad_grad_fn
from repro.checkpoint import CheckpointPolicy as JPolicy
from repro.core import L2GDHyper as JHyper
from repro.core import make_compressor as jmake
from repro.fl import run_l2gd as jrun
from repro_torch import checkpoint
from repro_torch.checkpoint import CheckpointManager, CheckpointPolicy
from repro_torch.core import (L2GDHyper, Identity, init_state,
                              make_compressor, prng)
from repro_torch.core.async_engine import init_async_state, rollout_l2gd_async
from repro_torch.core.rollout import rollout_l2gd
from repro_torch.core.tree import tree_leaves
from repro_torch.fl import run_l2gd
from repro_torch.fl.faults import FaultPlan
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain

N, D = 4, 12
BATCH = torch.from_numpy(np.array(quad_batch(N, D)))
HP = L2GDHyper(eta=0.1, lam=0.5, p=0.4, n=N)
FAULTS = FaultPlan(max_delay=2, drop_rate=0.1, crash_rate=0.05,
                   quorum=0.75)
STEPS, CHUNK = 24, 6
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


def _quad(params, batch):
    g = params["w"] - batch
    return 0.5 * torch.sum(g ** 2, dim=1), {"w": g}


def _rollout(key, steps=STEPS, *, codec="qsgd", grad_fn=_quad, **kw):
    return run_l2gd(key, {"w": torch.zeros(N, D)}, grad_fn, HP,
                    lambda k: BATCH, steps,
                    client_comp=make_compressor(codec), chunk=CHUNK,
                    device="cpu", **kw)


def _assert_bit_exact(base, other):
    for tree in ("params", "cache"):
        got = tree_leaves(getattr(other.state, tree))
        want = tree_leaves(getattr(base.state, tree))
        assert len(got) == len(want)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (other.state.step, other.state.xi_prev) == \
        (base.state.step, base.state.xi_prev)
    assert other.losses == base.losses
    assert other.evals == base.evals
    assert other.ledger == base.ledger
    assert np.array_equal(other.xis, base.xis)
    assert (other.n_local, other.n_agg_comm, other.n_agg_cached) \
        == (base.n_local, base.n_agg_comm, base.n_agg_cached)
    assert other.fault_stats == base.fault_stats


@pytest.mark.parametrize("participation", [None, 0.5],
                         ids=["full", "part0.5"])
@pytest.mark.parametrize("engine", ["sync", "async"])
@pytest.mark.parametrize("codec", ["identity", "qsgd", "natural"])
def test_resume_bit_exact(tmp_path, codec, engine, participation):
    """Snapshotting changes nothing, and a resume from every boundary
    reproduces the uninterrupted run (the last: zero steps left, the
    traces and ledger restored whole)."""
    kw = dict(codec=codec, participation=participation,
              faults=FAULTS if engine == "async" else None,
              eval_fn=lambda p: float(torch.sum(p["w"] ** 2)),
              eval_every=CHUNK)
    key = prng.PRNGKey(3)
    root = str(tmp_path / "ckpt")
    base = _rollout(key, **kw)
    pol = CheckpointPolicy(root)
    _assert_bit_exact(base, _rollout(key, checkpoint_policy=pol, **kw))
    pol.resolve().close()
    assert checkpoint.all_steps(root) == list(range(CHUNK, STEPS + 1, CHUNK))
    for step in checkpoint.all_steps(root):
        resumed = _rollout(key, resume_from=root, resume_step=step, **kw)
        _assert_bit_exact(base, resumed)


def test_cadence_counts_global_chunks(tmp_path):
    """every_n_chunks=3 of 4 chunks: boundaries 18 and the final 24; a
    run resumed at 18 snapshots the same boundaries again."""
    root = str(tmp_path / "ckpt")
    pol = CheckpointPolicy(root, every_n_chunks=3, wait=True)
    _rollout(prng.PRNGKey(1), checkpoint_policy=pol)
    assert checkpoint.all_steps(root) == [18, 24]
    other = str(tmp_path / "other")
    pol2 = CheckpointPolicy(other, every_n_chunks=3)
    _rollout(prng.PRNGKey(1), resume_from=root, resume_step=18,
             checkpoint_policy=pol2)
    assert checkpoint.all_steps(other) == [24]


@pytest.mark.parametrize("change", ["key", "steps", "participation",
                                    "codec", "faults"])
def test_mismatch_raises_before_any_step(tmp_path, change):
    root = str(tmp_path / "ckpt")
    pol = CheckpointPolicy(root)
    _rollout(prng.PRNGKey(3), checkpoint_policy=pol)
    pol.resolve().close()
    calls = []

    def counting(p, b):
        calls.append(1)
        return _quad(p, b)

    kw = {"key": dict(key=prng.PRNGKey(4)),
          "steps": dict(steps=30), "participation": dict(participation=0.5),
          "codec": dict(codec="natural"), "faults": dict(faults=FAULTS)}
    args = dict(key=prng.PRNGKey(3), **kw[change]) if change != "key" \
        else kw["key"]
    key = args.pop("key")
    with pytest.raises(ValueError, match="mismatch"):
        _rollout(key, resume_from=root, resume_step=CHUNK,
                 grad_fn=counting, **args)
    assert calls == []


def test_host_mode_refuses_checkpoints(tmp_path):
    with pytest.raises(ValueError, match="scan"):
        _rollout(prng.PRNGKey(0), mode="host",
                 checkpoint_policy=CheckpointPolicy(str(tmp_path)))


@pytest.mark.parametrize("loader", ["load_rollout_checkpoint",
                                    "unpack_snapshot"])
def test_snapshot_loaders_need_cuda_by_default(loader, tmp_path):
    """Like every entry point, the snapshot loaders put the state on CUDA
    unless the caller names a device: with no card they raise."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    from repro_torch.checkpoint import resume
    root = str(tmp_path / "ckpt")
    pol = CheckpointPolicy(root)
    _rollout(prng.PRNGKey(5), steps=CHUNK, checkpoint_policy=pol)
    pol.resolve().close()
    if loader == "load_rollout_checkpoint":
        def load(**kw):
            return resume.load_rollout_checkpoint(root, **kw)
    else:
        def load(**kw):
            return resume.unpack_snapshot(
                CheckpointManager(root).restore(None, lazy=True), **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load()
    snap = load(device="cpu")
    assert snap.state.params["w"].device.type == "cpu"
    assert int(snap.state.step) == CHUNK


def test_delta_snapshot_needs_lossy_opt_in(tmp_path):
    root = str(tmp_path / "ckpt")
    pol = CheckpointPolicy(root, mode="delta",
                           delta_plan=make_compressor("qsgd"))
    base = _rollout(prng.PRNGKey(3), checkpoint_policy=pol)
    pol.resolve().close()
    with pytest.raises(ValueError, match="LOSSY"):
        _rollout(prng.PRNGKey(3), resume_from=root, resume_step=2 * CHUNK)
    run = _rollout(prng.PRNGKey(3), resume_from=root, resume_step=2 * CHUNK,
                   allow_lossy_resume=True)
    assert run.state.params["w"].shape == (N, D)
    assert np.array_equal(run.xis, base.xis)
    assert run.ledger == base.ledger       # the protocol is unaffected
    # even a lossless delta plan re-rounds (x - base) + base
    root = str(tmp_path / "identity")
    pol = CheckpointPolicy(root, mode="delta", delta_plan=Identity())
    _rollout(prng.PRNGKey(3), checkpoint_policy=pol)
    pol.resolve().close()
    close = _rollout(prng.PRNGKey(3), resume_from=root,
                     resume_step=2 * CHUNK, allow_lossy_resume=True)
    np.testing.assert_allclose(close.state.params["w"].numpy(),
                               base.state.params["w"].numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("codec", ["identity", "qsgd"])
def test_port_continues_the_references_snapshot(tmp_path, codec):
    """The reference writes its snapshots; the port resumes from the
    middle boundary and ends within the bound of
    tests/test_torch_l2gd.py::test_run_l2gd_quadratic, its ledger, xi
    trace and counters exact."""
    root = str(tmp_path / "ref")
    jbatch = quad_batch(N, D)
    jhp = JHyper(eta=0.1, lam=0.5, p=0.4, n=N)
    pol = JPolicy(root)
    jr = jrun(jax.random.PRNGKey(3), {"w": jax.numpy.zeros((N, D))},
              quad_grad_fn, jhp, lambda k: jbatch, STEPS,
              client_comp=jmake(codec), chunk=CHUNK, checkpoint_policy=pol)
    pol.resolve().close()
    mid = STEPS // 2
    tr = _rollout(prng.PRNGKey(3), codec=codec, resume_from=root,
                  resume_step=mid)
    assert np.array_equal(tr.xis, np.asarray(jr.xis))
    assert (tr.n_local, tr.n_agg_comm, tr.n_agg_cached) == \
        (jr.n_local, jr.n_agg_comm, jr.n_agg_cached)
    assert tr.ledger.history == jr.ledger.history
    assert tr.ledger.bits_per_client == jr.ledger.bits_per_client
    assert tr.losses[:mid] == [(int(k), float(v)) for k, v in jr.losses[:mid]]
    base = np.asarray(jbatch)
    atol = 1e-5 if codec == "identity" else \
        np.abs(base).max() * np.sqrt(D) / 127
    np.testing.assert_allclose(tr.state.params["w"].numpy(),
                               np.asarray(jr.state.params["w"]), rtol=0,
                               atol=atol)
    np.testing.assert_allclose([v for _, v in tr.losses],
                               [v for _, v in jr.losses],
                               rtol=1e-4 if codec == "identity" else 1e-3)


@pytest.mark.parametrize("engine", ["sync", "async"])
def test_checkpointed_rollout_both_carries(tmp_path, engine):
    length = 6
    up = make_compressor("natural")
    faults = FAULTS

    if engine == "sync":
        def roll(state, batches, key):
            return rollout_l2gd(key, state, HP, batches, grad_fn=_quad,
                                steps=length, client_comp=up,
                                master_comp=up, batch_axis=None)
    else:
        def roll(state, agg, batches, key):
            return rollout_l2gd_async(key, state, HP, batches,
                                      grad_fn=_quad, fault_plan=faults,
                                      steps=length, client_comp=up,
                                      master_comp=up, batch_axis=None,
                                      agg_state=agg)

    root = str(tmp_path / "ckpt")
    wrapped = tsteps.checkpointed_rollout(roll, root, length=length,
                                          every=2, wait=True)
    state = init_state({"w": torch.zeros(N, D)})
    agg = init_async_state(state.params, up, faults)
    key = prng.PRNGKey(5)
    for i in range(4):
        args = (state,) if engine == "sync" else (state, agg)
        out = wrapped(*args, BATCH, key)
        state = out[0]
        if engine == "async":
            agg = out[1]
    wrapped.manager.close()
    assert wrapped.step == 24 and wrapped.dispatches == 4
    assert checkpoint.all_steps(root) == [12, 24]
    tree = CheckpointManager(root).restore(24, device="cpu")
    assert torch.equal(tree["state"]["params"]["w"], state.params["w"])
    assert int(tree["state"]["step"]) == state.step == 24
    if engine == "async":
        assert torch.equal(tree["agg"]["buf_w"], agg.buf_w)
        assert int(tree["agg"]["rnd"]) == agg.rnd


_CHILD = textwrap.dedent(r"""
    import sys, time
    import numpy as np, torch
    from repro_torch.core import L2GDHyper, make_compressor, prng
    from repro_torch.fl import run_l2gd
    from repro_torch.fl.faults import FaultPlan
    from repro_torch.checkpoint import CheckpointPolicy

    root, batch = sys.argv[1], torch.from_numpy(np.load(sys.argv[2]))
    hp = L2GDHyper(eta=0.1, lam=0.5, p=0.4, n=4)
    faults = FaultPlan(max_delay=2, drop_rate=0.1, crash_rate=0.05,
                       quorum=0.75)

    def quad(p, b):
        g = p["w"] - b
        return 0.5 * torch.sum(g ** 2, dim=1), {"w": g}

    def eval_fn(params):
        time.sleep(0.1)          # slow enough to be killed mid-run
        return float(torch.sum(params["w"] ** 2))

    pol = CheckpointPolicy(root, wait=True)
    run_l2gd(prng.PRNGKey(11), {"w": torch.zeros(4, 12)}, quad, hp,
             lambda k: batch, 600, client_comp=make_compressor("natural"),
             chunk=6, eval_fn=eval_fn, eval_every=6, participation=0.5,
             faults=faults, checkpoint_policy=pol, device="cpu")
    assert "jax" not in sys.modules and "repro" not in sys.modules
""")


def test_sigkill_mid_run_then_resume_bit_exact(tmp_path):
    root = str(tmp_path / "ckpt")
    batch_path = str(tmp_path / "batch.npy")
    np.save(batch_path, BATCH.numpy())
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, "-c", _CHILD, root, batch_path],
                            env=env)
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if len(checkpoint.all_steps(root)) >= 3:
                break
            if proc.poll() is not None:
                pytest.fail(f"child exited before the kill "
                            f"(rc={proc.returncode})")
            time.sleep(0.05)
        else:
            pytest.fail("fewer than 3 snapshots before the deadline")
        os.kill(proc.pid, signal.SIGKILL)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    latest = checkpoint.latest_step(root)
    assert latest is not None and 0 < latest < 600
    kw = dict(codec="natural", participation=0.5, faults=FAULTS,
              eval_fn=lambda p: float(torch.sum(p["w"] ** 2)),
              eval_every=CHUNK)
    base = _rollout(prng.PRNGKey(11), 600, **kw)
    resumed = _rollout(prng.PRNGKey(11), 600, resume_from=root, **kw)
    _assert_bit_exact(base, resumed)


CLI = ["--clients", "2", "--batch", "2", "--seq", "16", "--steps", "6",
       "--layers", "1", "--d-model", "64", "--heads", "2", "--kv-heads", "2",
       "--d-ff", "128", "--vocab", "128", "--compressor", "qsgd"]


def test_train_cli_checkpoints_and_resumes(tmp_path, capsys):
    """--ckpt FILE (an uninterrupted run saving its params), --ckpt DIR
    --ckpt-every 1 (snapshots change nothing), then --resume: all equal
    bit for bit."""
    single = str(tmp_path / "final.ckpt")
    plain = ttrain.main(CLI + ["--ckpt", single], device="cpu")
    params, extra = checkpoint.restore_state(single, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(params), tree_leaves(plain.state.params)))
    assert extra["steps"] == 6
    root = str(tmp_path / "ck")
    ckpt = ttrain.main(CLI + ["--ckpt", root, "--ckpt-every", "1",
                              "--ckpt-keep", "2"], device="cpu")
    assert checkpoint.latest_step(root) == 6
    resumed = ttrain.main(CLI + ["--ckpt", root, "--resume"], device="cpu")
    out = capsys.readouterr().out
    assert f"resuming from {root} step 6" in out
    for run in (ckpt, resumed):
        _assert_bit_exact(plain, run)
    with pytest.raises(SystemExit):
        ttrain.main(CLI + ["--resume"], device="cpu")
