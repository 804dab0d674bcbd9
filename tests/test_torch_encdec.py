"""Parity of the port's encoder-decoder (whisper-medium) with the JAX
reference, on the reduced config (``reduced()``: 2 decoder and 2 encoder
layers, d_model 256, 4 heads, vocab 512, 16 stub frames), the
reference's ``init_params`` weights carried across
(``convert.params_from_numpy``): the normal draw behind the stub frames
(``core.prng.normal`` / ``tensor_normal`` against ``jax.random.normal``),
the sinusoidal positions, ``mha_attention`` in its self, masked, cross
and ``precomputed_kv`` forms, the parameter tree, forward and loss, the
gradient (remat on and off), decode through the self and cross caches,
the prefill step, the full config's parameter count, the train CLI's
frames and no jax on the path.

Bounds (float32, measured here with jax 0.9.0 and torch 2.13 on the
CPU): the blocks, logits, losses and decode-against-forward bounds of
tests/test_torch_lm.py (BLOCK_TOL, LOGIT_TOL, DECODE_TOL: the
reference's own 2e-4), the gradient bound of tests/test_torch_train.py
(GRAD_RTOL).  A normal draw is held to ``prng.NORMAL_ULPS`` (4) ulps of
the reference's (3 measured; its log1p is not correctly rounded), and
``0.02 *`` it to one more (the product rounds once more).  The
sinusoidal table is within SIN_TABLE_ABS (one ulp of 0.5, 6e-8; 98.7% of
4096 x 1024 values bit-exact) of the reference's, which XLA computes as
a constant; the reference's decode row at a traced index is XLA's
runtime pow and sine, 1e-6 from its own table at positions below 16
(1.5e-5 at 255), held to SIN_ROW_ABS.
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
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.models import param_count as jparam_count
from repro.models.model import _encoder_forward as jencoder_forward
from repro_torch.configs import get_config
from repro_torch.convert import check_tree_like, params_from_numpy
from repro_torch.core import prng
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import steps
from repro_torch.launch import train as ttrain
from repro_torch.models import (decode_step, encoder_forward, forward,
                                init_caches, init_params, loss_fn,
                                param_count)
from repro_torch.models import attention as attn
from repro_torch.models import blocks
from repro_torch.models import model as model_lib
from repro_torch.models.frontends import (stub_frame_embeddings,
                                          stub_frontend)

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
ARCH = "whisper-medium"
BLOCK_TOL = 1e-6
LOGIT_TOL = 2e-5
DECODE_TOL = 2e-4
GRAD_RTOL = 2e-5
SIN_TABLE_ABS = 6e-8
SIN_ROW_ABS = 2e-6
WHISPER_PARAMS = 959_204_352


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
    """Elementwise distance in float32 ulps (the ordered-integer view)."""
    a, b = (np.asarray(x, np.float32).view(np.int32).astype(np.int64)
            for x in (a, b))
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return np.abs(a - b)


def _cfgs(**changes):
    return (dataclasses.replace(get_config(ARCH).reduced(), **changes),
            dataclasses.replace(jget_config(ARCH).reduced(), **changes))


def _carried(jcfg, seed=0):
    jp = jinit_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _batch(cfg, B=2, S=10, seed=1):
    """(tokens, frames) as numpy: the frames the reference's scale of a
    seeded normal."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    frames = (0.02 * rng.standard_normal(
        (B, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)
    return tokens, frames


def _both(tokens, frames):
    return ({"tokens": tokens, "frames": frames},
            {"tokens": _t(tokens).long(), "frames": _t(frames)})


# --------------------------------------------------------------------------
# the normal draw behind the stub frontends
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed, step, shape", [
    (2, 0, (2, 2, 16, 256)),        # the CLI's frames key at a test size
    (1, 5, (2, 2, 16, 256)),        # its patches key
    (2, 3, (1, 1, 1500, 1024)),     # one whisper-medium example
    (0, 0, ()),
])
def test_normal_matches_jax_random_normal(seed, step, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    want = np.asarray(jax.random.normal(key, shape))
    words = prng.fold_in(prng.PRNGKey(seed), step)
    assert np.array_equal(words, np.asarray(key))
    host = prng.normal(words, shape)
    dev = prng.tensor_normal(words, shape, "cpu")
    assert host.dtype == np.float32 and host.shape == want.shape
    assert dev.dtype == torch.float32 and tuple(dev.shape) == want.shape
    assert ulps(host, want).max() <= prng.NORMAL_ULPS
    assert ulps(dev.numpy(), want).max() <= prng.NORMAL_ULPS
    if want.size > 1000:
        assert (ulps(dev.numpy(), want) == 0).mean() > 0.98
    # the chunked draw changes no bit
    chunk = prng.DRAW_CHUNK
    try:
        prng.DRAW_CHUNK = 1000
        assert torch.equal(prng.tensor_normal(words, shape, "cpu"), dev)
    finally:
        prng.DRAW_CHUNK = chunk


def test_stub_frames_are_the_reference_expression():
    cfg, jcfg = _cfgs()
    key = jax.random.PRNGKey(4)
    from repro.models.frontends import stub_frame_embeddings as jstub
    want = np.asarray(jstub(key, jcfg, 2, 3))
    got = stub_frame_embeddings(np.asarray(key), cfg, 2, 3, device="cpu")
    assert tuple(got.shape) == want.shape == (2, 3, 16, 256)
    assert ulps(got.numpy(), want).max() <= prng.NORMAL_ULPS + 1
    batch = stub_frontend(np.asarray(key), cfg, {"tokens": 0}, 2, 3,
                          device="cpu")
    assert torch.equal(batch["frames"], got) and batch["tokens"] == 0
    stablelm = get_config("stablelm-1.6b").reduced()
    assert stub_frontend(np.asarray(key), stablelm, {"tokens": 0},
                         device="cpu") == {"tokens": 0}
    with pytest.raises(AssertionError):
        stub_frame_embeddings(np.asarray(key), stablelm, device="cpu")


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

def test_sinusoidal_positions_match_reference():
    want = np.asarray(jblocks.sinusoidal_positions(4096, 1024))
    got = blocks.sinusoidal_positions(4096, 1024, "cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= SIN_TABLE_ABS
    assert (got.numpy() == want).mean() > 0.98
    small = blocks.sinusoidal_positions(16, 256, "cpu")
    assert np.abs(small.numpy() - np.asarray(
        jblocks.sinusoidal_positions(16, 256))).max() <= SIN_TABLE_ABS
    at = jax.jit(lambda i: jblocks.sinusoidal_position_at(i, 256))
    for i in range(16):
        row = blocks.sinusoidal_position_at(i, 256, "cpu")
        assert torch.equal(row, small[i])        # decode == forward's row
        assert np.abs(row.numpy() - np.asarray(
            at(jnp.asarray(i, jnp.int32)))).max() <= SIN_ROW_ABS


@pytest.mark.parametrize("form", ["self", "masked", "cross", "precomputed"])
def test_mha_attention_matches_reference(form):
    rng = np.random.default_rng(3)
    B, S, T, H, D, d = 2, 7, 11, 4, 16, 64
    jp = jattn.init_mha(jax.random.PRNGKey(0), d, H, D, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    src = rng.standard_normal((B, S if form in ("self", "masked") else T,
                               d)).astype(np.float32)
    kw, tkw = {}, {}
    if form == "masked":
        kw["mask"] = jattn.causal_mask(S, S)
        tkw["mask"] = attn.causal_mask(S, S)
    if form == "precomputed":
        kv = tuple(rng.standard_normal((B, T, H, D)).astype(np.float32)
                   for _ in range(2))
        kw["precomputed_kv"] = kv
        tkw["precomputed_kv"] = tuple(map(_t, kv))
    fn = jax.jit(lambda p, a, b: jattn.mha_attention(
        p, a, b, n_heads=H, head_dim=D, **kw))
    want, (wk, wv) = fn(jp, x, src)
    got, (k, v) = attn.mha_attention(tp, _t(x), _t(src), n_heads=H,
                                     head_dim=D, **tkw)
    assert got.shape == want.shape
    assert _max_err(got, want) < BLOCK_TOL
    assert _max_err(k, wk) < BLOCK_TOL and _max_err(v, wv) < BLOCK_TOL
    if form == "precomputed":
        assert k is tkw["precomputed_kv"][0]


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def test_whisper_tree_equals_reference():
    cfg, jcfg = _cfgs()
    jp, tp = _carried(jcfg)
    assert {"cross", "encoder", "encoder_norm"} <= set(tp)
    check_tree_like(tp, init_params(None, cfg, device="meta"))
    own = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    check_tree_like(own, tp)
    assert param_count(own) == jparam_count(jp)
    assert tp["encoder"]["ffn"]["w_gate"].shape == (2, 256, 512)
    assert tp["cross"]["attn"]["wk"].shape == (2, 256, 256)


def test_full_whisper_param_count_on_meta():
    cfg = get_config(ARCH)
    params = init_params(None, cfg, device="meta")
    assert param_count(params) == WHISPER_PARAMS
    shapes = jparam_shapes(jget_config(ARCH))
    check_tree_like(params, jax.tree.map(
        lambda s: torch.empty(s.shape, dtype=torch.float32, device="meta"),
        shapes))
    assert jparam_count(shapes) == WHISPER_PARAMS


def test_forward_and_loss_match_reference():
    cfg, jcfg = _cfgs()
    jp, tp = _carried(jcfg)
    jb, tb = _both(*_batch(cfg))
    want, jaux = jax.jit(lambda p, b: jforward(p, jcfg, b))(jp, jb)
    got, aux = forward(tp, cfg, tb)
    assert got.shape == want.shape == (2, 10, cfg.vocab_size)
    assert got.dtype == torch.float32
    assert _max_err(got, want) < LOGIT_TOL
    assert float(aux) == float(jaux) == 0.0
    enc = encoder_forward(tp, cfg, tb["frames"])
    jenc = jax.jit(lambda p, f: jencoder_forward(p, jcfg, f))(jp, jb["frames"])
    assert _max_err(enc, jenc) < LOGIT_TOL
    jl, jm = jax.jit(lambda p, b: jloss_fn(p, jcfg, b))(jp, jb)
    tl, tm = loss_fn(tp, cfg, tb)
    assert abs(float(tl) - float(jl)) < BLOCK_TOL * float(jl)
    assert abs(float(tm["ce"]) - float(jm["ce"])) < BLOCK_TOL * float(jl)
    # the frames reach the logits
    other = dict(tb, frames=tb["frames"].flip(1))
    assert not torch.allclose(forward(tp, cfg, other)[0], got)


def test_grad_matches_jax_grad_and_remat_on_equals_off(monkeypatch):
    cfg, jcfg = _cfgs()
    jp, tp = _carried(jcfg)
    jb, tb = _both(*_batch(cfg, S=12))

    def one(p, b):
        return jax.value_and_grad(lambda q: jloss_fn(q, jcfg, b)[0])(p)

    jl, jg = jax.jit(one)(jp, jb)
    stacked = jax.tree.map(lambda a: a[None], tp)
    sbatch = jax.tree.map(lambda a: a[None], tb)
    calls = []
    real = model_lib.checkpoint

    def spy(fn, *args, **kw):
        calls.append(fn.__name__)
        return real(fn, *args, **kw)

    monkeypatch.setattr(model_lib, "checkpoint", spy)
    grads = {}
    for remat in (False, True):
        fn = steps.stacked_grad_fn(dataclasses.replace(cfg, remat=remat))
        grads[remat] = fn(stacked, sbatch)
    assert calls == ["_encoder_layer"] * cfg.encoder_layers \
        + ["_encdec_layer"] * cfg.n_layers
    tl, tg = grads[False]
    assert abs(float(tl[0]) - float(jl)) < BLOCK_TOL * float(jl)
    for got, want in zip(tree_leaves(tg), jax.tree.leaves(jg)):
        assert _rel(got[0].numpy(), want) <= GRAD_RTOL
    assert torch.equal(grads[True][0], tl)
    for a, b in zip(tree_leaves(grads[True][1]), tree_leaves(tg)):
        assert torch.equal(a, b)


def _fill_cross(params, cfg, caches, frames):
    """The cross caches from the encoder's output, as the reference's
    test fills them (tests/test_models_smoke.py)."""
    enc = encoder_forward(params, cfg, frames)
    B, H, D = enc.shape[0], cfg.n_heads, cfg.hd
    for c, wk, wv in zip(caches, params["cross"]["attn"]["wk"],
                         params["cross"]["attn"]["wv"]):
        c["cross_k"] = (enc @ wk).reshape(B, -1, H, D)
        c["cross_v"] = (enc @ wv).reshape(B, -1, H, D)
    return caches


def _jfill_cross(params, cfg, caches, frames):
    enc = jencoder_forward(params, cfg, frames)
    B, H, D = enc.shape[0], cfg.n_heads, cfg.hd
    return [dict(c, cross_k=(enc @ params["cross"]["attn"]["wk"][i])
                 .reshape(B, -1, H, D),
                 cross_v=(enc @ params["cross"]["attn"]["wv"][i])
                 .reshape(B, -1, H, D)) for i, c in enumerate(caches)]


@pytest.mark.parametrize("filled", [False, True])
def test_decode_matches_reference_and_own_forward(filled):
    """Ten teacher-forced tokens through the caches: against the
    reference's decode_step, with its zero cross caches (as init_caches
    makes them; no reference code fills them) and with cross caches
    filled from the encoder; filled, against the port's own forward at
    the reference's 2e-4 bound."""
    cfg, jcfg = _cfgs()
    jp, tp = _carried(jcfg)
    B, S = 2, 10
    tokens, frames = _batch(cfg, B, S)
    caches = init_caches(cfg, B, S, device="cpu")
    jcaches = jinit_caches(jcfg, B, S)
    assert [(tuple(c["self"].k.shape), tuple(c["cross_k"].shape))
            for c in caches] == \
        [(tuple(c["self"].k.shape), tuple(c["cross_k"].shape))
         for c in jcaches]
    assert all(not c["cross_k"].any() and not c["cross_v"].any()
               for c in caches)
    if filled:
        caches = _fill_cross(tp, cfg, caches, _t(frames))
        jcaches = _jfill_cross(jp, jcfg, jcaches, frames)
    jstep = jax.jit(lambda p, c, i, b: jdecode_step(p, jcfg, c, i, b))
    serve = steps.build_serve_step(cfg)
    full, _ = forward(tp, cfg, _both(tokens, frames)[1])
    errs_ref, errs_own = [], []
    for i in range(S):
        want, jcaches = jstep(jp, jcaches, jnp.asarray(i, jnp.int32),
                              {"tokens": tokens[:, i:i + 1]})
        got, caches = serve(tp, caches, i,
                            {"tokens": _t(tokens[:, i:i + 1]).long()})
        errs_ref.append(_max_err(got, want[:, 0]))
        errs_own.append(float((got - full[:, i]).abs().max()))
    assert max(errs_ref) < LOGIT_TOL, errs_ref
    if filled:
        assert max(errs_own) < DECODE_TOL, errs_own
    else:     # zero cross caches: not the forward's attention
        assert max(errs_own) > DECODE_TOL
    assert caches[0]["self"].k[:, S - 1].abs().max() > 0


def test_prefill_step_matches_reference():
    cfg, jcfg = _cfgs()
    jp, tp = _carried(jcfg)
    jb, tb = _both(*_batch(cfg, 2, 16))
    want = jax.jit(jbuild_prefill(jcfg))(jp, jb)
    tp["embed"]["table"].requires_grad_()
    got = steps.build_prefill_step(cfg)(tp, tb)
    assert got.shape == (2, cfg.vocab_size) and not got.requires_grad
    assert _max_err(got, want) < LOGIT_TOL


# --------------------------------------------------------------------------
# the train CLI
# --------------------------------------------------------------------------

CLI = ["--arch", ARCH, "--clients", "2", "--batch", "2", "--seq", "12",
       "--steps", "4", "--layers", "1", "--d-model", "64", "--heads", "2",
       "--kv-heads", "2", "--d-ff", "128", "--vocab", "128",
       "--compressor", "qsgd", "--log-every", "2"]


def test_train_cli_draws_the_reference_frames(monkeypatch, capsys):
    """The CLI trains reduced whisper-medium on the CPU; each step's
    frames are the reference CLI's expression, ``0.02 * normal(fold_in(
    PRNGKey(seed + 2), k), (n, batch, F, d_model))``."""
    seen = []
    real = ttrain.run_l2gd

    def spy(key, params, grad_fn, hp, batch_fn, *args, **kw):
        seen.append(batch_fn)
        return real(key, params, grad_fn, hp, batch_fn, *args, **kw)

    monkeypatch.setattr(ttrain, "run_l2gd", spy)
    run = ttrain.main(CLI + ["--seed", "3"], device="cpu")
    out = capsys.readouterr().out
    assert "arch=whisper-medium" in out and "final loss" in out
    assert run.n_local + run.n_agg_comm + run.n_agg_cached == 4
    assert all(np.isfinite(v) for _, v in run.losses)
    for k in (0, 3):
        batch = seen[0](k)
        assert set(batch) == {"tokens", "frames"}
        assert batch["tokens"].shape == (2, 2, 12)
        want = 0.02 * jax.random.normal(
            jax.random.fold_in(jax.random.PRNGKey(3 + 2), k),
            (2, 2, 16, 64))
        assert batch["frames"].device.type == "cpu"
        assert ulps(batch["frames"].numpy(), want).max() \
            <= prng.NORMAL_ULPS + 1


def test_encdec_path_loads_no_jax_and_no_reference():
    """The encoder-decoder's prefill, decode and train CLI on the CPU
    load neither jax nor the JAX package."""
    code = (
        "import sys, torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.core import prng\n"
        "from repro_torch.launch.steps import build_prefill_step, "
        "build_serve_step\n"
        "from repro_torch.launch.train import main\n"
        "from repro_torch.models import init_caches, init_params\n"
        "from repro_torch.models.frontends import stub_frame_embeddings\n"
        "cfg = get_config('whisper-medium').reduced()\n"
        "p = init_params(torch.Generator().manual_seed(0), cfg, "
        "device='cpu')\n"
        "f = stub_frame_embeddings(prng.PRNGKey(0), cfg, 2, device='cpu')\n"
        "t = torch.zeros((2, 8), dtype=torch.long)\n"
        "assert build_prefill_step(cfg)(p, {'tokens': t, 'frames': f})"
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
