"""Parity of the port's vision-prefix decoder (internvl2-26b) with the JAX
reference, on the reduced config (``reduced()``: 2 layers, d_model 256,
4 heads, vocab 512, 16 stub patches; the GQA tests narrow the KV heads
to 2), the reference's ``init_params`` weights carried across
(``convert.params_from_numpy``): the stub patches, the parameter tree,
forward and loss with dense and flash attention (the patches in front of
the tokens, one causal mask over both), the loss's mask over the patch
positions, the gradient (remat on and off), decode, the prefill step,
the full config's parameter count, the train CLI's patches and no jax on
the path.

Bounds are tests/test_torch_lm.py's and tests/test_torch_train.py's
(float32, measured here with jax 0.9.0 and torch 2.13 on the CPU):
BLOCK_TOL for the losses, LOGIT_TOL for logits, DECODE_TOL (the
reference's 2e-4) for decode against forward, GRAD_RTOL for gradients;
a patch draw within ``prng.NORMAL_ULPS + 1`` ulps of the reference's
(tests/test_torch_encdec.py).
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_threads import torch_one_thread  # noqa: F401
from repro.configs import get_config as jget_config
from repro.launch.steps import build_prefill_step as jbuild_prefill
from repro.launch.steps import param_shapes as jparam_shapes
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.models import param_count as jparam_count
from repro.models.frontends import stub_patch_embeddings as jstub_patches
from repro_torch.configs import get_config
from repro_torch.convert import check_tree_like, params_from_numpy
from repro_torch.core import prng
from repro_torch.core.tree import tree_leaves
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import steps
from repro_torch.launch import train as ttrain
from repro_torch.models import (blocks, decode_step, forward, init_caches,
                                init_params, loss_fn, param_count)
from repro_torch.models.frontends import stub_patch_embeddings

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
ARCH = "internvl2-26b"
BLOCK_TOL = 1e-6
LOGIT_TOL = 2e-5
DECODE_TOL = 2e-4
GRAD_RTOL = 2e-5
INTERNVL_PARAMS = 19_292_614_656


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _max_err(got, want):
    """max |got - want|, relative to max |want| where that exceeds 1."""
    want = _np(want)
    return float(np.max(np.abs(_np(got) - want))
                 / max(1.0, float(np.max(np.abs(want)))))


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-30))


def ulps(a, b):
    a, b = (np.asarray(x, np.float32).view(np.int32).astype(np.int64)
            for x in (a, b))
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return np.abs(a - b)


def _cfgs(**changes):
    changes = {"n_kv_heads": 2, **changes}     # keep the GQA of the full
    return (dataclasses.replace(get_config(ARCH).reduced(), **changes),
            dataclasses.replace(jget_config(ARCH).reduced(), **changes))


def _carried(jcfg, seed=0):
    jp = jinit_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _batch(cfg, B=2, S=10, seed=1):
    """(reference batch, port batch): S tokens after the patches, the
    patches the reference's stub of PRNGKey(seed)."""
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    patches = np.asarray(jstub_patches(jax.random.PRNGKey(seed), cfg, B))
    return ({"tokens": tokens, "patches": patches},
            {"tokens": _t(tokens).long(), "patches": _t(patches)})


def test_stub_patches_are_the_reference_expression():
    cfg, jcfg = _cfgs()
    key = jax.random.PRNGKey(5)
    want = np.asarray(jstub_patches(key, jcfg, 2))
    got = stub_patch_embeddings(np.asarray(key), cfg, 2, device="cpu")
    assert tuple(got.shape) == want.shape == (2, 16, 256)
    assert ulps(got.numpy(), want).max() <= prng.NORMAL_ULPS + 1
    with pytest.raises(AssertionError):
        stub_patch_embeddings(np.asarray(key), get_config(
            "whisper-medium").reduced(), device="cpu")


def test_internvl_tree_and_full_param_count():
    cfg, jcfg = _cfgs()
    jp, tp = _carried(jcfg)
    check_tree_like(tp, init_params(None, cfg, device="meta"))
    assert param_count(tp) == jparam_count(jp)
    full = init_params(None, get_config(ARCH), device="meta")
    assert param_count(full) == INTERNVL_PARAMS
    shapes = jparam_shapes(jget_config(ARCH))
    check_tree_like(full, jax.tree.map(
        lambda s: torch.empty(s.shape, dtype=torch.float32, device="meta"),
        shapes))
    assert jparam_count(shapes) == INTERNVL_PARAMS


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_forward_and_loss_match_reference(impl):
    cfg, jcfg = _cfgs(attn_impl=impl)
    jp, tp = _carried(jcfg)
    jb, tb = _batch(cfg)
    want, _ = jax.jit(lambda p, b: jforward(p, jcfg, b))(jp, jb)
    calls = []
    real = flash_ops.flash_attention_op

    def spy(q, *args, **kw):
        calls.append(q.shape)
        return real(q, *args, **kw)

    flash_ops.flash_attention_op = spy
    try:
        got, aux = forward(tp, cfg, tb)
    finally:
        flash_ops.flash_attention_op = real
    P = cfg.n_frontend_tokens
    assert got.shape == want.shape == (2, P + 10, cfg.vocab_size)
    assert _max_err(got, want) < LOGIT_TOL
    assert float(aux) == 0.0
    # flash covers the patches and the tokens: S = P + 10, GQA 4 / 2
    assert calls == ([(2, P + 10, 4, 64)] * cfg.n_layers
                     if impl == "flash" else [])
    jl, jm = jax.jit(lambda p, b: jloss_fn(p, jcfg, b))(jp, jb)
    tl, tm = loss_fn(tp, cfg, tb)
    assert abs(float(tl) - float(jl)) < BLOCK_TOL * float(jl)
    assert abs(float(tm["ce"]) - float(jm["ce"])) < BLOCK_TOL * float(jl)


def test_loss_leaves_the_patch_positions_out():
    cfg, jcfg = _cfgs()
    _, tp = _carried(jcfg)
    _, tb = _batch(cfg)
    P = cfg.n_frontend_tokens
    logits, _ = forward(tp, cfg, tb)
    loss, metrics = loss_fn(tp, cfg, tb)
    text = blocks.cross_entropy_loss(logits[:, P:-1], tb["tokens"][:, 1:])
    assert torch.equal(loss, text) and torch.equal(metrics["ce"], text)
    # the patch positions would change it; the patches themselves reach
    # the text positions through attention
    assert not torch.equal(text, blocks.cross_entropy_loss(
        logits[:, :9], tb["tokens"][:, 1:]))
    other = dict(tb, patches=tb["patches"].flip(1))
    assert not torch.equal(loss_fn(tp, cfg, other)[0], loss)
    # without patches the batch is a plain decoder's
    plain, _ = forward(tp, cfg, {"tokens": tb["tokens"]})
    assert plain.shape == (2, 10, cfg.vocab_size)


def test_grad_matches_jax_grad_and_remat_on_equals_off():
    cfg, jcfg = _cfgs()
    jp, tp = _carried(jcfg)
    jb, tb = _batch(cfg, S=12)

    def one(p, b):
        return jax.value_and_grad(lambda q: jloss_fn(q, jcfg, b)[0])(p)

    jl, jg = jax.jit(one)(jp, jb)
    stacked = jax.tree.map(lambda a: a[None], tp)
    sbatch = jax.tree.map(lambda a: a[None], tb)
    grads = {remat: steps.stacked_grad_fn(
        dataclasses.replace(cfg, remat=remat))(stacked, sbatch)
        for remat in (False, True)}
    tl, tg = grads[False]
    assert abs(float(tl[0]) - float(jl)) < BLOCK_TOL * float(jl)
    for got, want in zip(tree_leaves(tg), jax.tree.leaves(jg)):
        assert _rel(got[0].numpy(), want) <= GRAD_RTOL
    assert torch.equal(grads[True][0], tl)
    for a, b in zip(tree_leaves(grads[True][1]), tree_leaves(tg)):
        assert torch.equal(a, b)
    # the loss-only route gives the gradient route's loss
    assert torch.equal(steps.stacked_loss_fn(cfg)(stacked, sbatch), tl)


def test_decode_matches_reference_and_own_forward():
    """Decode takes tokens only, as the reference's: ten teacher-forced
    tokens through the GQA caches against the reference's decode_step
    and the port's forward on the same tokens without patches."""
    cfg, jcfg = _cfgs()
    jp, tp = _carried(jcfg)
    B, S = 2, 10
    _, tb = _batch(cfg, B, S)
    tokens = tb["tokens"]
    full, _ = forward(tp, cfg, {"tokens": tokens})
    caches = init_caches(cfg, B, S, device="cpu")
    jcaches = jinit_caches(jcfg, B, S)
    jstep = jax.jit(lambda p, c, i, b: jdecode_step(p, jcfg, c, i, b))
    errs_ref, errs_own = [], []
    for i in range(S):
        want, jcaches = jstep(jp, jcaches, jnp.asarray(i, jnp.int32),
                              {"tokens": tokens[:, i:i + 1].int().numpy()})
        got, caches = decode_step(tp, cfg, caches, i,
                                  {"tokens": tokens[:, i:i + 1]})
        errs_ref.append(_max_err(got, want))
        errs_own.append(float((got[:, 0] - full[:, i]).abs().max()))
    assert max(errs_ref) < LOGIT_TOL, errs_ref
    assert max(errs_own) < DECODE_TOL, errs_own


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_prefill_step_matches_reference(impl):
    cfg, jcfg = _cfgs(attn_impl=impl)
    jp, tp = _carried(jcfg)
    jb, tb = _batch(cfg, 2, 16)
    want = jax.jit(jbuild_prefill(jcfg))(jp, jb)
    got = steps.build_prefill_step(cfg)(tp, tb)
    assert got.shape == (2, cfg.vocab_size)
    assert _max_err(got, want) < LOGIT_TOL


# --------------------------------------------------------------------------
# the train CLI
# --------------------------------------------------------------------------

CLI = ["--arch", ARCH, "--clients", "2", "--batch", "2", "--seq", "28",
       "--steps", "4", "--layers", "1", "--d-model", "64", "--heads", "2",
       "--kv-heads", "1", "--d-ff", "128", "--vocab", "128",
       "--compressor", "natural", "--log-every", "2"]


def test_train_cli_draws_the_reference_patches(monkeypatch, capsys):
    """The CLI trains reduced internvl2-26b on the CPU; the 16 patches
    take 16 of --seq's 28 positions, and each step's patches are the
    reference CLI's expression, ``0.02 * normal(fold_in(PRNGKey(seed +
    1), k), (n, batch, P, d_model))``."""
    seen = []
    real = ttrain.run_l2gd

    def spy(key, params, grad_fn, hp, batch_fn, *args, **kw):
        seen.append(batch_fn)
        return real(key, params, grad_fn, hp, batch_fn, *args, **kw)

    monkeypatch.setattr(ttrain, "run_l2gd", spy)
    run = ttrain.main(CLI, device="cpu")
    out = capsys.readouterr().out
    assert "arch=internvl2-26b" in out and "final loss" in out
    assert all(np.isfinite(v) for _, v in run.losses)
    for k in (0, 2):
        batch = seen[0](k)
        assert set(batch) == {"tokens", "patches"}
        assert batch["tokens"].shape == (2, 2, 12)
        want = 0.02 * jax.random.normal(
            jax.random.fold_in(jax.random.PRNGKey(0 + 1), k),
            (2, 2, 16, 64))
        assert ulps(batch["patches"].numpy(), want).max() \
            <= prng.NORMAL_ULPS + 1
    with pytest.raises(SystemExit):
        ttrain.main(CLI[:6] + ["--seq", "17"] + CLI[8:], device="cpu")


def test_vlm_path_loads_no_jax_and_no_reference():
    """The vision prefix's prefill (flash route), decode and train CLI on
    the CPU load neither jax nor the JAX package."""
    code = (
        "import dataclasses, sys, torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.core import prng\n"
        "from repro_torch.launch.steps import build_prefill_step, "
        "build_serve_step\n"
        "from repro_torch.launch.train import main\n"
        "from repro_torch.models import init_caches, init_params\n"
        "from repro_torch.models.frontends import stub_patch_embeddings\n"
        "cfg = dataclasses.replace(get_config('internvl2-26b').reduced(), "
        "attn_impl='flash')\n"
        "p = init_params(torch.Generator().manual_seed(0), cfg, "
        "device='cpu')\n"
        "x = stub_patch_embeddings(prng.PRNGKey(0), cfg, 2, device='cpu')\n"
        "t = torch.zeros((2, 8), dtype=torch.long)\n"
        "assert build_prefill_step(cfg)(p, {'tokens': t, 'patches': x})"
        ".shape == (2, cfg.vocab_size)\n"
        "c = init_caches(cfg, 2, 8, device='cpu')\n"
        "build_serve_step(cfg)(p, c, 0, {'tokens': t[:, :1]})\n"
        "main(" + repr(CLI) + ", device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LOADED []" in out.stdout
