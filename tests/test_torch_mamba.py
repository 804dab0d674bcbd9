"""Parity of the port's Mamba and hybrid serving path with the JAX
reference: ``init_mamba``, the causal conv, the SSM projections and
softplus, the chunked scan (from a nonzero state, with its final state),
the Mamba mixer's forward and O(1) decode step, the Mamba cache as a
tree, and reduced falcon-mamba-7b and hymba-1.5b end to end (forward
logits, loss, ten decode steps against the reference's decode_step and
against the port's own forward, the prefill and serve step builders).

Inputs come from numpy seeds; model weights are the reference's
``init_params`` carried across with ``convert.params_from_numpy``.  The
JAX side is jitted.  hymba runs with 4 layers, not ``reduced()``'s 2
(with ``global_pattern="hymba"`` both of those are global), so that
layer 1 is windowed (window 8); decode runs past 8 tokens, so its ring
cache wraps.

Tolerances (float32, measured with jax 0.9.0 and torch 2.13 on the
CPU, each test states its own): the frameworks' exp, log1p and matrix
products differ in the last bits, and the chunked scan's prefix combine
runs in another order than JAX's associative_scan tree, so blocks agree
within BLOCK_TOL and the reduced models' logits within LOGIT_TOL
(relative to the largest magnitude where that exceeds 1), the bounds of
tests/test_torch_lm.py; decode against the port's own forward is held
to the reference's 2e-4 (tests/test_models_smoke.py).
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
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.models import mamba as jmb
from repro_torch.configs import get_config
from repro_torch.convert import check_tree_like, params_from_numpy
from repro_torch.core.tree import tree_flatten, tree_map
from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.launch.steps import build_prefill_step, build_serve_step
from repro_torch.models import (decode_step, forward, init_caches,
                                init_params, layer_kinds, loss_fn,
                                param_count)
from repro_torch.models import mamba as mb

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
BLOCK_TOL = 1e-6
LOGIT_TOL = 2e-5
DECODE_TOL = 2e-4
D_MODEL, N_STATE = 64, 16


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _max_err(got, want):
    """max |got - want|, relative to max |want| where that exceeds 1."""
    want = _np(want)
    return float(np.max(np.abs(_np(got) - want))
                 / max(1.0, float(np.max(np.abs(want)))))


def _carried_mamba(seed=0, d_model=D_MODEL, expand=2):
    jp = jmb.init_mamba(jax.random.PRNGKey(seed), d_model, N_STATE, expand)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _scan_inputs(B, L, E, N, seed=0):
    rng = np.random.default_rng(seed)
    dt = np.logaddexp(rng.normal(size=(B, L, E)), 0.0) * 0.2
    return tuple(a.astype(np.float32) for a in (
        dt, rng.normal(size=(B, L, N)), rng.normal(size=(B, L, N)),
        rng.normal(size=(B, L, E)), -np.abs(rng.normal(size=(E, N)))))


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def test_init_mamba_has_the_reference_leaves_and_exact_values():
    jp, carried = _carried_mamba()
    gen = torch.Generator().manual_seed(0)
    own = mb.init_mamba(gen, D_MODEL, N_STATE, 2, 4, device="cpu")
    check_tree_like(own, carried)
    check_tree_like(mb.init_mamba(None, D_MODEL, N_STATE, 2, 4,
                                  device="meta"), carried)
    E = 2 * D_MODEL
    # A_log = log(1..N), the correctly rounded float32 values
    exact = np.log(np.arange(1, N_STATE + 1, dtype=np.float64)) \
        .astype(np.float32)
    assert np.array_equal(own["A_log"].numpy(), np.tile(exact, (E, 1)))
    # the reference's eager XLA:CPU log is one ulp high at log(7) (its
    # jitted, constant-folded log is not); every other entry is equal
    ref = np.asarray(jp["A_log"])
    off = ref != own["A_log"].numpy()
    assert not off[:, np.arange(N_STATE) != 6].any()
    assert np.all(np.abs(ref[off] - exact[6]) <= np.spacing(exact[6]))
    for name, value in (("D", 1.0), ("conv_b", 0.0)):
        assert torch.equal(own[name], torch.full((E,), value))
        assert np.array_equal(np.asarray(jp[name]), own[name].numpy())
    # dt_bias is the inverse softplus of a log-uniform dt in [1e-3, 0.1]
    for dt_bias in (own["dt_bias"], carried["dt_bias"]):
        dt = mb.softplus(dt_bias).double()
        assert float(dt.min()) >= 0.001 * (1 - 1e-5)
        assert float(dt.max()) <= 0.1 * (1 + 1e-5)
    wide = mb.init_mamba(gen, 512, N_STATE, 2, 4, device="cpu")
    log_dt = torch.log(mb.softplus(wide["dt_bias"]).double())
    # uniform on [log 1e-3, log 0.1]: mean log(0.01), std 4.605 / sqrt(12)
    assert abs(float(log_dt.mean()) - np.log(0.01)) < 0.1
    assert abs(float(log_dt.std()) - np.log(100) / np.sqrt(12)) < 0.1
    # truncated-normal projections; conv_w and dt_proj with their scales
    assert float(own["conv_w"].abs().max()) <= 2 * 4 ** -0.5
    assert float(own["dt_proj"].abs().max()) <= 2 * 4 ** -0.5  # rank 4
    assert float(own["in_proj_x"].abs().max()) <= 2 * D_MODEL ** -0.5


# --------------------------------------------------------------------------
# blocks of the mixer
# --------------------------------------------------------------------------

def test_softplus_is_the_reference_logaddexp():
    """The reference's ``logaddexp(x, 0)`` form.  F.softplus returns x
    above its threshold 20; there the reference's formula rounds to x as
    well, so the threshold never changes a float32 value."""
    x = np.concatenate([np.linspace(-40, 40, 20001),
                        [-1e4, -88, 20, 20.5, 1e4]]).astype(np.float32)
    got = mb.softplus(_t(x))
    want = jax.jit(jax.nn.softplus)(x)
    assert _max_err(got, want) < BLOCK_TOL
    big = torch.from_numpy(x[x >= 20])
    assert torch.equal(mb.softplus(big), big)
    assert torch.equal(torch.nn.functional.softplus(big), big)


def test_causal_conv1d_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 11, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    b = rng.normal(size=24).astype(np.float32)
    got = mb._causal_conv1d(_t(x), _t(w), _t(b))
    want = jax.jit(jmb._causal_conv1d)(x, w, b)
    assert got.shape == (2, 11, 24)
    assert _max_err(got, want) < BLOCK_TOL


def test_ssm_inputs_match_reference():
    jp, tp = _carried_mamba(2)
    xc = np.random.default_rng(2).normal(size=(2, 9, 2 * D_MODEL)) \
        .astype(np.float32)
    want = jax.jit(jmb._ssm_inputs, static_argnums=2)(jp, xc, N_STATE)
    got = mb._ssm_inputs(tp, _t(xc), N_STATE)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        assert _max_err(g, w) < BLOCK_TOL


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_selective_scan_chunked_matches_reference(chunk):
    """From a nonzero state, L = 37 (ragged against every chunk); y and
    the final state."""
    B, L, E, N = 2, 37, 24, 8
    ins = _scan_inputs(B, L, E, N, seed=chunk)
    h0 = np.random.default_rng(0).normal(size=(B, E, N)).astype(np.float32)
    want_y, want_h = jax.jit(jmb.selective_scan_chunked,
                             static_argnames="chunk")(*ins, h0, chunk=chunk)
    got_y, got_h = mb.selective_scan_chunked(*map(_t, ins), _t(h0), chunk)
    assert got_y.dtype == got_h.dtype == torch.float32
    # measured: 2.4e-7 (the prefix combine's order against JAX's tree)
    assert _max_err(got_y, want_y) < BLOCK_TOL
    assert _max_err(got_h, want_h) < BLOCK_TOL


def test_chunked_scan_equals_the_kernels_function_from_zero():
    """From h0 = 0 the chunked scan computes the kernel's function (the
    plain version), up to the order of the combine."""
    ins = [_t(a) for a in _scan_inputs(2, 37, 24, 8, seed=3)]
    y, _ = mb.selective_scan_chunked(*ins, torch.zeros(2, 24, 8), 8)
    assert _max_err(y, selective_scan_ref(*ins)) < BLOCK_TOL


def test_mamba_forward_matches_reference():
    jp, tp = _carried_mamba(4)
    x = np.random.default_rng(4).normal(size=(2, 19, D_MODEL)) \
        .astype(np.float32)
    want = jax.jit(lambda p, a: jmb.mamba_forward(p, a, d_state=N_STATE,
                                                  chunk=4))(jp, x)
    got = mb.mamba_forward(tp, _t(x), d_state=N_STATE, chunk=4)
    assert got.shape == (2, 19, D_MODEL)
    assert _max_err(got, want) < BLOCK_TOL


def test_mamba_forward_routes_the_scan_by_device(monkeypatch):
    """A CPU tensor takes the chunked scan and never the op; a tensor for
    which the dispatch rule says "kernel" takes the op (here faked by the
    plain version) and never the chunked scan."""
    _, tp = _carried_mamba(5)
    x = _t(np.random.default_rng(5).normal(size=(1, 10, D_MODEL))
           .astype(np.float32))

    def refuse(*args):
        raise AssertionError("the op ran on a CPU tensor")

    monkeypatch.setattr(scan_ops, "selective_scan_op", refuse)
    cpu = mb.mamba_forward(tp, x, d_state=N_STATE, chunk=4)
    calls = []

    def fake_op(dt, Bm, Cm, xc, A):
        calls.append(xc.shape)
        return selective_scan_ref(dt, Bm, Cm, xc, A)

    monkeypatch.setattr(scan_ops, "selective_scan_op", fake_op)
    monkeypatch.setattr(mb, "use_kernel", lambda *t: True)
    monkeypatch.setattr(mb, "selective_scan_chunked", refuse)
    kernel_route = mb.mamba_forward(tp, x, d_state=N_STATE, chunk=4)
    assert calls == [(1, 10, 2 * D_MODEL)]
    assert _max_err(kernel_route, cpu) < BLOCK_TOL


def test_mamba_decode_matches_reference_and_own_forward():
    """Ten one-token steps: against the reference's decode step (the
    cache written in place, the same object returned) and against the
    port's own full-sequence forward."""
    jp, tp = _carried_mamba(6)
    B, S, E = 2, 10, 2 * D_MODEL
    xs = np.random.default_rng(6).normal(size=(B, S, D_MODEL)) \
        .astype(np.float32)
    full = mb.mamba_forward(tp, _t(xs), d_state=N_STATE, chunk=4)
    jc = jmb.init_mamba_cache(B, E, N_STATE, 4, jnp.float32)
    tc = mb.init_mamba_cache(B, E, N_STATE, 4, torch.float32, "cpu")
    assert [tuple(a.shape) for a in tc] == [a.shape for a in jc]
    jstep = jax.jit(lambda p, a, c: jmb.mamba_decode_step(p, a, c,
                                                          d_state=N_STATE))
    for i in range(S):
        want, jc = jstep(jp, xs[:, i:i + 1], jc)
        got, tc2 = mb.mamba_decode_step(tp, _t(xs[:, i:i + 1]), tc,
                                        d_state=N_STATE)
        assert tc2 is tc and got.shape == (B, 1, D_MODEL)
        assert _max_err(got, want) < BLOCK_TOL, i
        assert _max_err(tc.conv, jc.conv) < BLOCK_TOL
        assert _max_err(tc.h, jc.h) < BLOCK_TOL
        # measured: 6.0e-8 (GEMV against GEMM, step against chunked scan)
        assert float((got[:, 0] - full[:, i]).abs().max()) < BLOCK_TOL


def test_mamba_cache_is_a_tree():
    """tree_map rebuilds a MambaCache; the reference's caches carried
    across keep their NamedTuples (the reference's class: the port never
    imports it) with the port's fields and leaf shapes."""
    cache = mb.init_mamba_cache(2, 8, 4, 4, torch.float32, "cpu")
    shifted = tree_map(lambda a: a + 1, cache)
    assert isinstance(shifted, mb.MambaCache)
    assert torch.equal(shifted.h, cache.h + 1)
    jcfg = dataclasses.replace(jget_config("hymba-1.5b").reduced(),
                               n_layers=4)
    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), n_layers=4)
    carried = params_from_numpy(jax.tree.map(
        np.asarray, jinit_caches(jcfg, 2, 12)))
    own = init_caches(cfg, 2, 12, device="cpu")
    for c, o in zip(carried, own):
        assert isinstance(c["mamba"], jmb.MambaCache)
        assert c["mamba"]._fields == o["mamba"]._fields
    assert [(tuple(a.shape), a.dtype) for a in tree_flatten(carried)[0]] \
        == [(tuple(a.shape), a.dtype) for a in tree_flatten(own)[0]]


# --------------------------------------------------------------------------
# reduced falcon-mamba-7b and hymba-1.5b
# --------------------------------------------------------------------------

def _reduced(arch):
    layers = 4 if arch == "hymba-1.5b" else 2
    return (dataclasses.replace(get_config(arch).reduced(), n_layers=layers),
            dataclasses.replace(jget_config(arch).reduced(),
                                n_layers=layers))


def _carried(jcfg, seed=0):
    jp = jinit_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _tokens(cfg, B=2, S=10, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


ARCHS = ("falcon-mamba-7b", "hymba-1.5b")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_equals_reference(arch):
    cfg, jcfg = _reduced(arch)
    jp, tp = _carried(jcfg)
    check_tree_like(tp, init_params(None, cfg, device="meta"))
    own = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    check_tree_like(own, tp)
    assert param_count(own) == sum(int(a.size)
                                   for a in jax.tree.leaves(jp))


def test_hymba_layer_pattern_and_caches():
    cfg, jcfg = _reduced("hymba-1.5b")
    assert [k.is_global for k in layer_kinds(cfg)] == [True, False, True,
                                                       True]
    caches = init_caches(cfg, 2, 20, device="cpu")
    assert [c["attn"].k.shape[1] for c in caches] == [20, 8, 20, 20]
    jcaches = jinit_caches(jcfg, 2, 20)
    for c, jc in zip(caches, jcaches):
        assert tuple(c["attn"].k.shape) == jc["attn"].k.shape
        assert [tuple(a.shape) for a in c["mamba"]] == \
            [a.shape for a in jc["mamba"]]
    falcon = init_caches(_reduced("falcon-mamba-7b")[0], 2, 20, device="cpu")
    assert all(isinstance(c, mb.MambaCache) for c in falcon)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    cfg, jcfg = _reduced(arch)
    jp, tp = _carried(jcfg)
    toks = _tokens(cfg, S=12)
    want, jaux = jax.jit(lambda p, t: jforward(p, jcfg, {"tokens": t}))(
        jp, toks)
    got, aux = forward(tp, cfg, {"tokens": _t(toks)})
    assert got.shape == want.shape and got.dtype == torch.float32
    # measured: 1.0e-6 (falcon), 2.0e-6 (hymba)
    assert _max_err(got, want) < LOGIT_TOL
    assert float(aux) == float(jaux) == 0.0
    jl, jm = jax.jit(lambda p, t: jloss_fn(p, jcfg, {"tokens": t}))(jp, toks)
    tl, tm = loss_fn(tp, cfg, {"tokens": _t(toks)})
    assert abs(float(tl) - float(jl)) < BLOCK_TOL * float(jl)
    assert abs(float(tm["ce"]) - float(jm["ce"])) < BLOCK_TOL * float(jl)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference_and_own_forward(arch):
    """Ten teacher-forced tokens through the caches (hymba's windowed
    layer wraps its ring of 8): against the reference's decode_step, and
    against the port's own forward at the reference's 2e-4 bound."""
    cfg, jcfg = _reduced(arch)
    jp, tp = _carried(jcfg)
    B, S = 2, 10
    toks = _tokens(cfg, B, S)
    full, _ = forward(tp, cfg, {"tokens": _t(toks)})
    caches = init_caches(cfg, B, S, device="cpu")
    jcaches = jinit_caches(jcfg, B, S)
    jstep = jax.jit(lambda p, c, i, b: jdecode_step(p, jcfg, c, i, b))
    errs_ref, errs_own = [], []
    for i in range(S):
        want, jcaches = jstep(jp, jcaches, jnp.asarray(i, jnp.int32),
                              {"tokens": toks[:, i:i + 1]})
        got, caches = decode_step(tp, cfg, caches, i,
                                  {"tokens": _t(toks[:, i:i + 1])})
        errs_ref.append(_max_err(got, want))
        errs_own.append(float((got[:, 0] - full[:, i]).abs().max()))
    # measured: 1.0e-6 / 1.8e-6 against the reference, 6.6e-7 / 1.1e-6
    # against the port's forward (falcon / hymba)
    assert max(errs_ref) < LOGIT_TOL, errs_ref
    assert max(errs_own) < DECODE_TOL, errs_own
    for got, want in zip(tree_flatten(caches)[0],
                         tree_flatten(jax.tree.map(np.asarray, jcaches))[0]):
        assert _max_err(got, want) < LOGIT_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_step_builders_match_reference(arch):
    cfg, jcfg = _reduced(arch)
    jp, tp = _carried(jcfg)
    toks = _tokens(cfg, 2, 16)
    want = jax.jit(jbuild_prefill(jcfg))(jp, {"tokens": toks})
    got = build_prefill_step(cfg)(tp, {"tokens": _t(toks)})
    assert got.shape == (2, cfg.vocab_size) and not got.requires_grad
    assert _max_err(got, want) < LOGIT_TOL
    serve = build_serve_step(cfg)
    first, caches = serve(tp, init_caches(cfg, 2, 4, device="cpu"), 0,
                          {"tokens": _t(toks[:, :1])})
    assert torch.equal(first, decode_step(
        tp, cfg, init_caches(cfg, 2, 4, device="cpu"), 0,
        {"tokens": _t(toks[:, :1])})[0][:, 0])


def test_full_configs_param_counts_on_meta():
    counts = {"falcon-mamba-7b": 7_006_326_784, "hymba-1.5b": 1_352_246_400}
    for arch, count in counts.items():
        cfg = get_config(arch)
        params = init_params(None, cfg, device="meta")
        assert param_count(params) == count
        shapes = jax.eval_shape(lambda k: jinit_params(k, jget_config(arch)),
                                jax.random.PRNGKey(0))
        check_tree_like(params, jax.tree.map(
            lambda s: torch.empty(s.shape, dtype=torch.float32,
                                  device="meta"), shapes))


def test_mamba_path_loads_no_jax_and_no_reference():
    """The Mamba and hybrid serving path on the CPU loads neither jax nor
    the JAX package."""
    code = (
        "import dataclasses, sys, torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.launch.steps import build_prefill_step, "
        "build_serve_step\n"
        "from repro_torch.models import init_caches, init_params\n"
        "for arch in ('falcon-mamba-7b', 'hymba-1.5b'):\n"
        "    cfg = dataclasses.replace(get_config(arch).reduced(), "
        "n_layers=4)\n"
        "    p = init_params(torch.Generator().manual_seed(0), cfg, "
        "device='cpu')\n"
        "    t = torch.randint(0, cfg.vocab_size, (2, 8))\n"
        "    assert build_prefill_step(cfg)(p, {'tokens': t}).shape == "
        "(2, cfg.vocab_size)\n"
        "    c = init_caches(cfg, 2, 8, device='cpu')\n"
        "    build_serve_step(cfg)(p, c, 0, {'tokens': t[:, :1]})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LOADED []" in out.stdout
