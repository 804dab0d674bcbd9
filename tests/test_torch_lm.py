"""Parity of the port's LM serving path with the JAX reference: configs,
the model blocks, GQA attention in its three layouts, the dense decoder's
forward, loss and KV-cache decode for reduced stablelm-1.6b and reduced
gemma3-1b (qk-norm, GeLU, sliding-window ring caches, every_k), the
prefill and serve step builders and the token stream.

Inputs come from numpy seeds; model weights are the reference's
``init_params`` carried across with ``convert.params_from_numpy`` (the
port draws its own with a torch.Generator, which gives other numbers).
The JAX side is jitted.

Tolerances (float32, measured here with jax 0.9.0 and torch 2.13 on the
CPU, each test states its own): the two frameworks' matrix products sum
in different orders and their pow / sin / cos / exp differ in the last
bit, so blocks agree within BLOCK_TOL and logits of the 2-layer models
within LOGIT_TOL (both relative to the largest magnitude where that
exceeds 1); the port's decode against its own forward is held to the
reference's 2e-4 bound (tests/test_models_smoke.py).
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
from repro.configs.base import ARCH_IDS as J_ARCH_IDS
from repro.configs.base import INPUT_SHAPES as J_INPUT_SHAPES
from repro.configs.base import ArchConfig as JArchConfig
from repro.data.tokens import TokenStream as JTokenStream
from repro.launch.steps import build_prefill_step as jbuild_prefill
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.models import param_count as jparam_count
from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, ArchConfig,
                                 get_config)
from repro_torch.convert import check_tree_like, params_from_numpy
from repro_torch.data import TokenStream
from repro_torch.kernels import dispatch
from repro_torch.launch.steps import build_prefill_step, build_serve_step
from repro_torch.models import (decode_step, forward, init_caches,
                                init_params, layer_kinds, loss_fn,
                                param_count)
from repro_torch.models import attention as attn
from repro_torch.models import blocks

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
# the ported archs; the dense GQA ones are exercised here, falcon-mamba-7b
# and hymba-1.5b in tests/test_torch_mamba.py, the MoE and MLA family in
# tests/test_torch_moe_lm.py, whisper-medium in tests/test_torch_encdec.py
# and internvl2-26b in tests/test_torch_vlm.py
ARCHS = ("stablelm-1.6b", "gemma3-1b", "falcon-mamba-7b", "hymba-1.5b",
         "granite-moe-1b-a400m", "moonshot-v1-16b-a3b",
         "deepseek-v2-lite-16b", "whisper-medium", "internvl2-26b",
         "mistral-large-123b")
GQA_ARCHS = ARCHS[:2] + ("mistral-large-123b",)
BLOCK_TOL = 1e-6
LOGIT_TOL = 2e-5
DECODE_TOL = 2e-4
STABLELM_PARAMS = 1_438_746_624


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _max_err(got, want):
    """max |got - want|, relative to max |want| where that exceeds 1."""
    want = _np(want)
    return float(np.max(np.abs(_np(got) - want))
                 / max(1.0, float(np.max(np.abs(want)))))


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

def test_arch_config_has_every_field_of_the_reference():
    ours = [(f.name, f.default) for f in dataclasses.fields(ArchConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(JArchConfig)]
    assert ours == theirs
    assert ARCH_IDS == J_ARCH_IDS
    assert {k: dataclasses.astuple(s) for k, s in INPUT_SHAPES.items()} == \
        {k: dataclasses.astuple(s) for k, s in J_INPUT_SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_ported_configs_equal_the_reference(arch):
    for ours, theirs in ((get_config(arch), jget_config(arch)),
                         (get_config(arch).reduced(),
                          jget_config(arch).reduced())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert (ours.hd, ours.d_inner, ours.supports_long_context()) == \
            (theirs.hd, theirs.d_inner, theirs.supports_long_context())


def test_unported_configs_raise_and_name_their_slice():
    # every assigned architecture is ported now (mistral-large-123b, the
    # last, with the multi-device launch layer): none raises
    assert set(ARCHS) == set(ARCH_IDS)
    for arch in ARCH_IDS:
        assert get_config(arch).name == arch


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

def test_rmsnorm_rope_embed_loss_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 6, 4, 64)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, size=64).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 9)[None], (2, 6)).astype(np.int32)
    assert _max_err(blocks.rmsnorm({"scale": _t(scale)}, _t(x), 1e-6),
                    jax.jit(jblocks.rmsnorm, static_argnums=2)(
                        {"scale": scale}, x, 1e-6)) < BLOCK_TOL
    for theta in (1e4, 1e6):
        got = blocks.apply_rope(_t(x), _t(pos), theta)
        want = jax.jit(jblocks.apply_rope, static_argnums=2)(x, pos, theta)
        assert _max_err(got, want) < BLOCK_TOL, theta
    assert _max_err(blocks.rope_frequencies(64, 1e4),
                    jblocks.rope_frequencies(64, 1e4)) < 1e-9
    table = rng.normal(size=(50, 64)).astype(np.float32)
    h = rng.normal(size=(2, 6, 64)).astype(np.float32)
    toks = rng.integers(0, 50, size=(2, 6)).astype(np.int32)
    assert np.array_equal(blocks.embed({"table": _t(table)}, _t(toks)),
                          jblocks.embed({"table": table}, toks))
    logits = blocks.unembed({"table": _t(table)}, _t(h))
    assert _max_err(logits, jax.jit(jblocks.unembed)({"table": table}, h)) \
        < 1e-5
    mask = (rng.random((2, 6)) < 0.7).astype(np.float32)
    for m in (None, mask):
        got = blocks.cross_entropy_loss(logits, _t(toks),
                                        None if m is None else _t(m))
        want = jax.jit(jblocks.cross_entropy_loss)(_np(logits), toks, m)
        assert abs(float(got) - float(want)) < BLOCK_TOL * float(want)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_mlp_matches_reference(fused, activation):
    jp = jblocks.init_mlp(jax.random.PRNGKey(1), 64, 96, jnp.float32,
                          fused=fused)
    x = np.random.default_rng(1).normal(size=(2, 5, 64)).astype(np.float32)
    got = blocks.mlp(params_from_numpy(jax.tree.map(np.asarray, jp)), _t(x),
                     activation)
    want = jax.jit(jblocks.mlp, static_argnums=2)(jp, x, activation)
    assert _max_err(got, want) < BLOCK_TOL


def test_dense_init_is_a_truncated_normal():
    gen = torch.Generator().manual_seed(0)
    w = blocks.dense_init(gen, (256, 512), torch.float32, device="cpu")
    std = 256 ** -0.5
    assert float(w.abs().max()) <= 2 * std
    # the standard normal cut to [-2, 2] has std 0.8796
    assert abs(float(w.std()) / std - 0.8796) < 0.01
    emb = blocks.init_embedding(gen, 100, 64, torch.float32, device="cpu")
    assert float(emb["table"].abs().max()) <= 0.04
    meta = blocks.dense_init(None, (4, 8), torch.bfloat16, device="meta")
    assert meta.is_meta and meta.dtype == torch.bfloat16


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def test_causal_mask_and_core_match_reference():
    for S, T, window, offset in ((6, 6, None, 0), (6, 9, 3, 2), (1, 8, 4, 7)):
        assert np.array_equal(attn.causal_mask(S, T, window, offset),
                              jattn.causal_mask(S, T, window, offset))
    q, k, v = (np.random.default_rng(2).normal(size=s).astype(np.float32)
               for s in ((2, 7, 4, 64), (2, 9, 2, 64), (2, 9, 2, 64)))
    mask = np.asarray(jattn.causal_mask(7, 9, 4, 2))
    got = attn.attention_core(_t(q), _t(k), _t(v), _t(mask))
    want = jax.jit(jattn.attention_core)(q, k, v, mask)
    assert _max_err(got, want) < BLOCK_TOL


@pytest.mark.parametrize("layout", ["fused", "split", "qkv_fused"])
@pytest.mark.parametrize("impl,window,qk_norm",
                         [("dense", None, False), ("dense", 5, True),
                          ("flash", None, True), ("flash", 5, False)])
def test_gqa_attention_matches_reference(layout, impl, window, qk_norm):
    jp = jattn.init_gqa(jax.random.PRNGKey(3), 128, 4, 2, 64, jnp.float32,
                        qk_norm=qk_norm, layout=layout)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    shapes = attn.init_gqa(None, 128, 4, 2, 64, torch.float32, device="meta",
                           qk_norm=qk_norm, layout=layout)
    check_tree_like(tp, shapes)
    x = np.random.default_rng(3).normal(size=(2, 12, 128)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12)[None], (2, 12)).astype(np.int32)
    kw = dict(n_heads=4, n_kv=2, head_dim=64, theta=1e4, window=window,
              qk_norm=qk_norm, impl=impl)
    want, _ = jax.jit(lambda p, a, b: jattn.gqa_attention(p, a, b, **kw))(
        jp, x, pos)
    got, cache = attn.gqa_attention(tp, _t(x), _t(pos), **kw)
    assert cache is None
    assert _max_err(got, want) < BLOCK_TOL


@pytest.mark.parametrize("ring", [False, True])
def test_gqa_cache_path_matches_reference(ring):
    """Decode against the cache, ring buffer or linear; the port writes
    the cache in place."""
    C, steps = 4, 7 if ring else 4
    jp = jattn.init_gqa(jax.random.PRNGKey(4), 64, 4, 1, 64, jnp.float32,
                        qk_norm=True)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    jc = jattn.init_kv_cache(2, C, 1, 64, jnp.float32)
    tc = attn.init_kv_cache(2, C, 1, 64, torch.float32, "cpu")
    xs = np.random.default_rng(4).normal(size=(steps, 2, 1, 64)) \
        .astype(np.float32)
    kw = dict(n_heads=4, n_kv=1, head_dim=64, theta=1e4, qk_norm=True,
              ring=ring)
    step = jax.jit(lambda p, a, b, c, i: jattn.gqa_attention(
        p, a, b, cache=c, cache_index=i, **kw))
    for i in range(steps):
        pos = np.full((2, 1), i, np.int32)
        want, jc = step(jp, xs[i], pos, jc, jnp.asarray(i, jnp.int32))
        got, tc2 = attn.gqa_attention(tp, _t(xs[i]), _t(pos), cache=tc,
                                      cache_index=i, **kw)
        assert tc2 is tc
        assert _max_err(got, want) < BLOCK_TOL, i
        assert _max_err(tc.k, jc.k) < BLOCK_TOL
    if not ring:
        with pytest.raises(IndexError):
            attn.gqa_attention(tp, _t(xs[0]), _t(pos), cache=tc,
                               cache_index=C, **kw)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def _reduced(arch, **changes):
    return (dataclasses.replace(get_config(arch).reduced(), **changes),
            dataclasses.replace(jget_config(arch).reduced(), **changes))


def _carried(jcfg, seed=0):
    jp = jinit_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _tokens(cfg, B=2, S=10, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", GQA_ARCHS)
def test_init_params_tree_equals_reference(arch):
    cfg, jcfg = _reduced(arch)
    _, tp = _carried(jcfg)
    check_tree_like(tp, init_params(None, cfg, device="meta"))
    gen = torch.Generator().manual_seed(0)
    own = init_params(gen, cfg, device="cpu")
    check_tree_like(own, tp)
    assert param_count(own) == jparam_count(_carried(jcfg)[0])
    with pytest.raises(ValueError):
        check_tree_like({"embed": tp["embed"]}, tp)
    bad = dict(tp, final_norm={"scale": torch.ones(3)})
    with pytest.raises(ValueError, match="final_norm"):
        check_tree_like(bad, tp)


def test_full_stablelm_param_count_on_meta():
    cfg = get_config("stablelm-1.6b")
    params = init_params(None, cfg, device="meta")
    assert param_count(params) == STABLELM_PARAMS
    shapes = jax.eval_shape(lambda k: jinit_params(k, jget_config(cfg.name)),
                            jax.random.PRNGKey(0))
    check_tree_like(params, jax.tree.map(
        lambda s: torch.empty(s.shape, dtype=torch.float32, device="meta"),
        shapes))
    assert jparam_count(shapes) == STABLELM_PARAMS


@pytest.mark.parametrize("arch", GQA_ARCHS)
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_forward_and_loss_match_reference(arch, impl):
    cfg, jcfg = _reduced(arch, attn_impl=impl)
    jp, tp = _carried(jcfg)
    toks = _tokens(cfg)
    want, jaux = jax.jit(lambda p, t: jforward(p, jcfg, {"tokens": t}))(
        jp, toks)
    got, aux = forward(tp, cfg, {"tokens": _t(toks)})
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _max_err(got, want) < LOGIT_TOL
    assert float(aux) == float(jaux) == 0.0
    (jl, jm) = jax.jit(lambda p, t: jloss_fn(p, jcfg, {"tokens": t}))(
        jp, toks)
    tl, tm = loss_fn(tp, cfg, {"tokens": _t(toks)})
    assert abs(float(tl) - float(jl)) < BLOCK_TOL * float(jl)
    assert abs(float(tm["ce"]) - float(jm["ce"])) < BLOCK_TOL * float(jl)


def test_flash_and_dense_forward_agree():
    """stablelm (all layers global) takes the flash route; its logits
    equal the dense route's within the float32 bound.  gemma3 (sliding
    window) falls back to dense: bit-equal."""
    for arch, exact in (("stablelm-1.6b", False), ("gemma3-1b", True)):
        cfg, jcfg = _reduced(arch)
        _, tp = _carried(jcfg)
        toks = _t(_tokens(cfg))
        dense, _ = forward(tp, cfg, {"tokens": toks})
        flash, _ = forward(tp, dataclasses.replace(cfg, attn_impl="flash"),
                           {"tokens": toks})
        if exact:
            assert torch.equal(dense, flash)
        else:
            assert _max_err(dense, flash) < LOGIT_TOL


@pytest.mark.parametrize("arch", GQA_ARCHS)
def test_decode_matches_reference_and_own_forward(arch):
    """Ten teacher-forced tokens through the KV caches: against the
    reference's decode_step, and against the port's own forward at the
    reference's 2e-4 bound."""
    cfg, jcfg = _reduced(arch)
    jp, tp = _carried(jcfg)
    B, S = 2, 10
    toks = _tokens(cfg, B, S)
    full, _ = forward(tp, cfg, {"tokens": _t(toks)})
    caches = init_caches(cfg, B, S, device="cpu")
    jcaches = jinit_caches(jcfg, B, S)
    assert [tuple(c.k.shape) for c in caches] == \
        [tuple(c.k.shape) for c in jcaches]
    jstep = jax.jit(lambda p, c, i, b: jdecode_step(p, jcfg, c, i, b))
    serve = build_serve_step(cfg)
    errs_ref, errs_own = [], []
    for i in range(S):
        want, jcaches = jstep(jp, jcaches, jnp.asarray(i, jnp.int32),
                              {"tokens": toks[:, i:i + 1]})
        got, caches = decode_step(tp, cfg, caches, i,
                                  {"tokens": _t(toks[:, i:i + 1])})
        errs_ref.append(_max_err(got, want))
        errs_own.append(float((got[:, 0] - full[:, i]).abs().max()))
    assert max(errs_ref) < LOGIT_TOL, errs_ref
    assert max(errs_own) < DECODE_TOL, errs_own
    # the serve step is decode_step's logits at the one position
    caches = init_caches(cfg, B, S, device="cpu")
    first = serve(tp, caches, 0, {"tokens": _t(toks[:, :1])})[0]
    assert torch.equal(first, decode_step(
        tp, cfg, init_caches(cfg, B, S, device="cpu"), 0,
        {"tokens": _t(toks[:, :1])})[0][:, 0])


def test_gemma_layer_pattern_and_ring_caches():
    cfg, jcfg = _reduced("gemma3-1b")
    assert [k.is_global for k in layer_kinds(cfg)] == [False, True]
    caches = init_caches(cfg, 2, 20, device="cpu")
    assert [c.k.shape[1] for c in caches] == [cfg.sliding_window, 20]
    assert [tuple(c.k.shape) for c in caches] == \
        [tuple(c.k.shape) for c in jinit_caches(jcfg, 2, 20)]


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_prefill_step_matches_reference(impl):
    cfg, jcfg = _reduced("stablelm-1.6b", attn_impl=impl)
    jp, tp = _carried(jcfg)
    toks = _tokens(cfg, 2, 16)
    want = jax.jit(jbuild_prefill(jcfg))(jp, {"tokens": toks})
    tp = {k: v for k, v in tp.items()}
    tp["embed"]["table"].requires_grad_()
    got = build_prefill_step(cfg)(tp, {"tokens": _t(toks)})
    assert got.shape == (2, cfg.vocab_size) and not got.requires_grad
    assert _max_err(got, want) < LOGIT_TOL


def test_entry_points_need_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    cfg = get_config("stablelm-1.6b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(None, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_caches(cfg, 1, 4)
    assert dispatch.resolve_device("cpu").type == "cpu"


def test_init_params_refuses_a_generator_on_another_device():
    cfg = get_config("stablelm-1.6b").reduced()
    with pytest.raises(ValueError, match="generator"):
        init_params(torch.Generator().manual_seed(0), cfg, device="meta")


def test_token_stream_equals_reference():
    ours = TokenStream(n_clients=2, vocab=100352, batch=2, seq=64, seed=3)
    theirs = JTokenStream(n_clients=2, vocab=100352, batch=2, seq=64, seed=3)
    for step in (0, 5):
        assert np.array_equal(ours.batch_at(step), theirs.batch_at(step))


def test_lm_path_loads_no_jax_and_no_reference():
    """The LM serving path on the CPU loads neither jax nor the JAX
    package."""
    code = (
        "import sys, torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.data import TokenStream\n"
        "from repro_torch.launch.steps import build_prefill_step, "
        "build_serve_step\n"
        "from repro_torch.models import init_caches, init_params\n"
        "import dataclasses\n"
        "cfg = dataclasses.replace(get_config('stablelm-1.6b').reduced(), "
        "attn_impl='flash')\n"
        "p = init_params(torch.Generator().manual_seed(0), cfg, "
        "device='cpu')\n"
        "t = torch.from_numpy(TokenStream(1, cfg.vocab_size, 2, 8)"
        ".batch_at(0)[0]).long()\n"
        "assert build_prefill_step(cfg)(p, {'tokens': t}).shape == "
        "(2, cfg.vocab_size)\n"
        "c = init_caches(cfg, 2, 8, device='cpu')\n"
        "build_serve_step(cfg)(p, c, 0, {'tokens': t[:, :1]})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LOADED []" in out.stdout
