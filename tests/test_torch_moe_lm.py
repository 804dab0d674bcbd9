"""Parity of the port's MoE and MLA language models with the JAX
reference, on the reduced configs (``reduced()``: 2 layers, d_model 256,
vocab 512, 4 experts, top-2 routing, at most 1 shared expert and 1 dense
layer) of granite-moe-1b-a400m (GQA, no shared expert),
moonshot-v1-16b-a3b (GQA, a shared expert) and deepseek-v2-lite-16b (MLA,
a shared expert, a dense first layer in ``params["dense_layers"]``), the
reference's ``init_params`` weights carried across
(``convert.params_from_numpy``): init trees, forward / loss / ce / aux,
decode through the KV and latent caches, the prefill step and the full
configs' parameter counts.  Training is in tests/test_torch_moe_train.py.

Bounds are tests/test_torch_lm.py's (float32, measured here with jax
0.9.0 and torch 2.13 on the CPU): LOGIT_TOL for logits, BLOCK_TOL for
the losses and the aux loss, DECODE_TOL (the reference's 2e-4) for
decode against forward at ``capacity_factor`` 8 (decode routes one token
a group with C = k and drops nothing, so the prefill's capacity must not
drop either).  At these seeds the port routes every token as the
reference does (a route that flipped on an ulp would move the logits by
far more than the bounds).
"""
import dataclasses

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
from repro.models import param_count as jparam_count
from repro_torch.configs import get_config
from repro_torch.convert import check_tree_like, params_from_numpy
from repro_torch.launch import steps
from repro_torch.models import (decode_step, forward, init_caches,
                                init_params, loss_fn, param_count)
from repro_torch.models import attention as attn
from repro_torch.models import model as model_lib
from repro_torch.models import moe as moe_lib

ARCHS = ("granite-moe-1b-a400m", "moonshot-v1-16b-a3b",
         "deepseek-v2-lite-16b")
BLOCK_TOL = 1e-6
LOGIT_TOL = 2e-5
DECODE_TOL = 2e-4
FULL_PARAMS = {"granite-moe-1b-a400m": 1_334_628_352,
               "moonshot-v1-16b-a3b": 28_552_923_136,
               "deepseek-v2-lite-16b": 15_496_769_024}


def _cfgs(arch, **changes):
    return (dataclasses.replace(get_config(arch).reduced(), **changes),
            dataclasses.replace(jget_config(arch).reduced(), **changes))


def _carried(jcfg, seed=0):
    jp = jinit_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _tokens(cfg, B=2, S=10, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _max_err(got, want):
    """max |got - want|, relative to max |want| where that exceeds 1."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))
                 / max(1.0, float(np.max(np.abs(want)))))


# --------------------------------------------------------------------------
# parameter trees
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_equals_reference(arch):
    """The reference's tree (``dense_layers`` too) carries across through
    ``params_from_numpy`` and ``check_tree_like`` with no special case."""
    cfg, jcfg = _cfgs(arch)
    jp, tp = _carried(jcfg)
    assert ("dense_layers" in tp) == (cfg.first_dense_layers > 0)
    check_tree_like(tp, init_params(None, cfg, device="meta"))
    own = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    check_tree_like(own, tp)
    assert param_count(own) == jparam_count(jp)
    for key in tp:
        with pytest.raises(ValueError, match=key):
            check_tree_like({k: v for k, v in tp.items() if k != key}, own)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_param_count_on_meta(arch):
    cfg = get_config(arch)
    params = init_params(None, cfg, device="meta")
    shapes = jax.eval_shape(lambda k: jinit_params(k, jget_config(arch)),
                            jax.random.PRNGKey(0))
    assert param_count(params) == jparam_count(shapes) == FULL_PARAMS[arch]
    check_tree_like(params, jax.tree.map(
        lambda s: torch.empty(s.shape, dtype=torch.float32, device="meta"),
        shapes))


# --------------------------------------------------------------------------
# forward, loss, decode, prefill
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    cfg, jcfg = _cfgs(arch)
    jp, tp = _carried(jcfg)
    toks = _tokens(cfg)
    want, jaux = jax.jit(lambda p, t: jforward(p, jcfg, {"tokens": t}))(
        jp, toks)
    got, aux = forward(tp, cfg, {"tokens": _t(toks)})
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _max_err(got, want) < LOGIT_TOL
    assert float(aux) > 0 and abs(float(aux) - float(jaux)) \
        < BLOCK_TOL * float(jaux)
    jl, jm = jax.jit(lambda p, t: jloss_fn(p, jcfg, {"tokens": t}))(jp, toks)
    tl, tm = loss_fn(tp, cfg, {"tokens": _t(toks)})
    for got_v, want_v in ((tl, jl), (tm["ce"], jm["ce"]),
                          (tm["aux"], jm["aux"])):
        assert abs(float(got_v) - float(want_v)) < BLOCK_TOL * float(jl)
    # the total is ce + aux_loss_weight * aux
    assert float(tl) == float(tm["ce"] + cfg.aux_loss_weight * tm["aux"])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference_and_own_forward(arch):
    """Ten teacher-forced tokens through the KV / latent caches at
    capacity factor 8: against the reference's decode_step, and against
    the port's own forward at the reference's 2e-4 bound."""
    cfg, jcfg = _cfgs(arch, capacity_factor=8.0)
    jp, tp = _carried(jcfg)
    toks = _tokens(cfg)
    full, _ = forward(tp, cfg, {"tokens": _t(toks)})
    caches = init_caches(cfg, 2, 10, device="cpu")
    jcaches = jinit_caches(jcfg, 2, 10)
    if cfg.mixer == "mla":
        assert all(isinstance(c, attn.MLACache) for c in caches)
        assert [tuple(a.shape) for c in caches for a in c] == \
            [tuple(a.shape) for c in jcaches for a in c]
    jstep = jax.jit(lambda p, c, i, t: jdecode_step(p, jcfg, c, i,
                                                    {"tokens": t}))
    for i in range(10):
        jl, jcaches = jstep(jp, jcaches, jnp.asarray(i, jnp.int32),
                            toks[:, i:i + 1])
        lg, caches = decode_step(tp, cfg, caches, i,
                                 {"tokens": _t(toks[:, i:i + 1])})
        assert _max_err(lg, jl) < LOGIT_TOL
        assert float((lg[:, 0] - full[:, i]).abs().max()) < DECODE_TOL
    with pytest.raises(IndexError, match="capacity"):
        decode_step(tp, cfg, caches, 10, {"tokens": _t(toks[:, :1])})


@pytest.mark.parametrize("arch", ("stablelm-1.6b",) + ARCHS)
def test_aux_only_where_moe_runs(arch, monkeypatch):
    """The aux loss comes from the MoE layers alone: a model without MoE
    sums none (its layers return None, forward one zero), and decode,
    which discards the aux, never computes it."""
    cfg = get_config(arch).reduced()
    params = init_params(torch.Generator().manual_seed(0), cfg,
                         device="cpu")
    batch = {"tokens": _t(_tokens(cfg))}
    _, aux = model_lib._hidden_aux(params, cfg, batch)
    assert (aux is None) == (cfg.ffn != "moe")
    want = 0.0 if aux is None else float(aux)
    assert float(forward(params, cfg, batch)[1]) == want

    def refuse(*args):
        raise AssertionError("decode computed the aux loss")

    monkeypatch.setattr(moe_lib, "_aux_loss", refuse)
    caches = init_caches(cfg, 2, 4, device="cpu")
    logits, _ = decode_step(params, cfg, caches, 0,
                            {"tokens": batch["tokens"][:, :1]})
    assert logits.shape == (2, 1, cfg.vocab_size)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_reference(arch):
    cfg, jcfg = _cfgs(arch)
    jp, tp = _carried(jcfg)
    toks = _tokens(cfg, 2, 16)
    want = jax.jit(jbuild_prefill(jcfg))(jp, {"tokens": toks})
    got = steps.build_prefill_step(cfg)(tp, {"tokens": _t(toks)})
    assert got.shape == (2, cfg.vocab_size)
    assert _max_err(got, want) < LOGIT_TOL
