"""Parity of the port's MoE FFN and latent attention (MLA) with the JAX
reference, module by module: ``repro_torch.models.moe`` against
``repro.models.moe`` and the MLA half of ``models/attention.py``.

Routing is discrete, so the port is held in layers:

  * the capacity and the router's choice are exact (ties included: the
    lower expert index wins, as ``jax.lax.top_k``'s);
  * given the reference's top-k indices, the dispatch is bit-exact: the
    slot-major positions, the kept set and the (G, E, C) buffer map
    (read off the reference's own expert buffers);
  * given equal routes, outputs agree within OUT_TOL (float32 products
    summed in another order) and the aux loss within AUX_TOL;
  * the dispatch's autograd Function (a gather in both directions)
    against ``jax.grad`` within GRAD_RTOL and against plain autograd
    (an index gather, whose backward is ``index_add_``) within 1 ulp a
    slot.

MLA: the prefill (keys and values expanded from the latent) and the
absorbed decode against the reference's within BLOCK_TOL, and against
each other within the reference's 2e-4 (tests/test_models_smoke.py).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_threads import torch_one_thread  # noqa: F401
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as attn
from repro_torch.models import moe

OUT_TOL = 2e-6
AUX_TOL = 1e-6
GRAD_RTOL = 2e-5
BLOCK_TOL = 2e-6
DECODE_TOL = 2e-4
G, S, DM, E, K, FF = 2, 24, 32, 4, 2, 16


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))
                 / max(1.0, float(np.max(np.abs(want)))))


def _params(n_shared=1, seed=3, e=E):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), DM, e, n_shared, FF,
                       jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _x(seed=4, shape=(G, S, DM)):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), shape))


# --------------------------------------------------------------------------
# capacity and routing
# --------------------------------------------------------------------------

def test_moe_capacity_grid():
    for s in (1, 7, 64, 4096):
        for e in (4, 32, 64):
            for k in (1, 2, 6, 8):
                for cf in (1.0, 1.25, 2.0, 8.0):
                    assert moe.moe_capacity(s, e, k, cf) == \
                        jmoe.moe_capacity(s, e, k, cf)
    assert moe.moe_capacity(1, 32, 8, 1.25) == 8         # decode: C = k
    assert moe.moe_capacity(4096, 32, 8, 1.25) == 1280   # granite prefill


def test_route_matches_reference():
    jp, tp = _params()
    x = _x()
    jg, jv, ji = jax.jit(lambda a: jmoe._route(a, jp["router"], K))(x)
    g, v, i = moe._route(_t(x), tp["router"], K)
    assert _rel(g, jg) < AUX_TOL and _rel(v, jv) < AUX_TOL
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_route_ties_pick_the_lower_expert(k):
    """A zero router gives every expert the same gate: the reference's
    top_k picks experts 0..k-1, and so does the port's stable sort."""
    x = _x()
    _, jv, ji = jmoe._route(jnp.asarray(x), jnp.zeros((DM, E)), k)
    g, v, i = moe._route(_t(x), torch.zeros(DM, E), k)
    want = np.broadcast_to(np.arange(k), (G, S, k))
    np.testing.assert_array_equal(np.asarray(ji), want)
    np.testing.assert_array_equal(i.numpy(), want)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


# --------------------------------------------------------------------------
# the dispatch, given the reference's routes: bit-exact
# --------------------------------------------------------------------------

def _reference_buffers(jp, x, cf, monkeypatch):
    """The reference's (G, E, C) buffer -> token map, read off the
    expert buffers its gather dispatch builds (rows of x are distinct;
    an empty slot is the zero pad row, token S)."""
    seen = []

    def spy(params, expert_in):
        seen.append(np.asarray(expert_in))
        return expert_in

    monkeypatch.setattr(jmoe, "_experts_apply", spy)
    C = jmoe.moe_capacity(S, E, K, cf)
    jmoe._moe_gather(jp, jnp.asarray(x), n_experts=E, k=K, capacity=C)
    buf = seen[0]                                     # (G, E, C, d)
    idx = np.full((G, E, C), S, np.int64)
    for g in range(G):
        match = np.all(buf[g][:, :, None, :] == x[g][None, None], axis=-1)
        hit = match.any(-1)
        idx[g][hit] = match.argmax(-1)[hit]
    return idx, C


@pytest.mark.parametrize("cf", [1.0, 1.25, 2.0])
def test_dispatch_bit_exact_given_reference_routes(cf, monkeypatch):
    jp, _ = _params(seed=5)
    # a skewed router: most tokens want the same experts, so at cf <= 1.25
    # the buffers overflow and assignments drop
    jp = dict(jp, router=jp["router"].at[0, 0].add(4.0))
    x = _x(6)
    x[..., 0] = np.abs(x[..., 0]) + 1.0
    _, _, ji = jmoe._route(jnp.asarray(x), jp["router"], K)
    want, C = _reference_buffers(jp, x, cf, monkeypatch)
    topi = _t(ji).to(torch.int64)
    flat_e, pos, keep = moe._positions(topi, E, C)
    slot, src, tok = moe._maps(flat_e, pos, keep, S, E, C)
    # the port's buffer map in the reference's (G, E, C) layout
    got = tok.view(E, G, C).transpose(0, 1).numpy()
    got = np.where(got < G * S, got - np.arange(G)[:, None, None] * S, S)
    np.testing.assert_array_equal(got, want)
    # positions and the kept set, from the reference's map
    fe, p, kp = flat_e.numpy(), pos.numpy(), keep.numpy()
    for g in range(G):
        for a in range(K * S):
            where = np.flatnonzero(want[g, fe[g, a]] == a % S)
            assert kp[g, a] == (where.size == 1)
            if kp[g, a]:
                assert p[g, a] == where[0]
            else:
                assert p[g, a] >= C
    if cf < 2.0:
        assert not kp.all()                           # drops happened
    # slot and src are inverse maps on the kept assignments
    kept = slot.reshape(-1) < E * G * C
    assert torch.equal(src[slot.reshape(-1)[kept]],
                       torch.arange(K * G * S)[kept])


# --------------------------------------------------------------------------
# outputs and aux loss, gather and einsum
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [1.0, 1.25, 2.0, 8.0])
@pytest.mark.parametrize("n_shared", [0, 1])
def test_moe_ffn_matches_reference(cf, n_shared):
    jp, tp = _params(n_shared)
    x = _x()
    outs = {}
    for impl in ("gather", "einsum"):
        jy, ja = jax.jit(lambda p, a: jmoe.moe_ffn(
            p, a, n_experts=E, k=K, capacity_factor=cf, impl=impl,
            n_shared=n_shared))(jp, x)
        y, aux = moe.moe_ffn(tp, _t(x), n_experts=E, k=K,
                             capacity_factor=cf, impl=impl,
                             n_shared=n_shared)
        assert y.shape == (G, S, DM) and aux.dtype == torch.float32
        assert _rel(y, jy) < OUT_TOL
        assert abs(float(aux) - float(ja)) < AUX_TOL
        outs[impl] = (y, aux)
    assert _rel(outs["gather"][0], outs["einsum"][0]) < OUT_TOL
    assert abs(float(outs["gather"][1]) - float(outs["einsum"][1])) < AUX_TOL


def test_decode_groups_never_drop():
    """One token a group: C = k, every assignment kept, so decode equals
    the uncapped einsum oracle."""
    jp, tp = _params()
    x = _t(_x(shape=(G, 1, DM)))
    y, _ = moe.moe_ffn(tp, x, n_experts=E, k=K, capacity_factor=1.25)
    want, _ = moe.moe_ffn(tp, x, n_experts=E, k=K, capacity_factor=1.25,
                          impl="einsum")
    assert _rel(y, want) < OUT_TOL
    _, _, topi = moe._route(x, tp["router"], K)
    assert moe._positions(topi, E, K)[2].all()


# --------------------------------------------------------------------------
# the dispatch's backward
# --------------------------------------------------------------------------

def _loss_weights(seed=9):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (G, S, DM)))


@pytest.mark.parametrize("cf", [1.0, 2.0])
def test_dispatch_backward_matches_jax_grad(cf):
    jp, tp = _params()
    x, r = _x(), _loss_weights()

    def jloss(p, a):
        y, aux = jmoe.moe_ffn(p, a, n_experts=E, k=K, capacity_factor=cf,
                              n_shared=1)
        return jnp.sum(y * r) + aux

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, x)
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    xt = _t(x).requires_grad_()
    y, aux = moe.moe_ffn(tp, xt, n_experts=E, k=K, capacity_factor=cf,
                         n_shared=1)
    (torch.sum(y * _t(r)) + aux).backward()
    assert _rel(xt.grad, jgx) < GRAD_RTOL
    for name, leaf in tp.items():
        want = np.asarray(jgp[name])
        assert float(np.max(np.abs(leaf.grad.numpy() - want))) \
            <= GRAD_RTOL * max(float(np.max(np.abs(want))), 1e-30), name


def test_dispatch_backward_equals_plain_autograd(monkeypatch):
    """The Function's gather-only backward against autograd of plain
    index gathers (``index_add_``): each token's gradient sums its k
    slots, in slot order here and in buffer order there — within one
    rounding a slot.  Two runs of the Function are bit-identical."""
    _, tp = _params()
    x, r = _x(), _t(_loss_weights())

    def grads():
        p = {k: v.detach().clone().requires_grad_() for k, v in tp.items()}
        xt = _t(x).requires_grad_()
        y, aux = moe.moe_ffn(p, xt, n_experts=E, k=K, capacity_factor=1.25,
                             n_shared=1)
        (torch.sum(y * r) + aux).backward()
        return [xt.grad] + [p[k].grad for k in sorted(p)]

    ours, again = grads(), grads()
    for a, b in zip(ours, again):
        assert torch.equal(a, b)
    monkeypatch.setattr(
        moe._RowGather, "apply",
        staticmethod(lambda src, index, inverse: torch.cat(
            [src, src.new_zeros((1,) + src.shape[1:])])[index]))
    plain = grads()
    for a, b in zip(ours, plain):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= K * np.spacing(
            np.float32(max(scale, 1e-30)))


# --------------------------------------------------------------------------
# MLA
# --------------------------------------------------------------------------

MLA = dict(n_heads=4, kv_lora=16, theta=1e4, nope_dim=8, rope_dim=4, v_dim=8)


def _mla_params(seed=0):
    jp = jattn.init_mla(jax.random.PRNGKey(seed), DM, MLA["n_heads"],
                        MLA["kv_lora"], jnp.float32,
                        nope_dim=MLA["nope_dim"], rope_dim=MLA["rope_dim"],
                        v_dim=MLA["v_dim"])
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def test_init_mla_tree_equals_reference():
    jp, tp = _mla_params()
    own = attn.init_mla(torch.Generator().manual_seed(0), DM,
                        MLA["n_heads"], MLA["kv_lora"], torch.float32,
                        device="cpu", nope_dim=MLA["nope_dim"],
                        rope_dim=MLA["rope_dim"], v_dim=MLA["v_dim"])
    from repro_torch.convert import check_tree_like
    check_tree_like(own, tp)


def test_mla_prefill_and_decode_match_reference():
    jp, tp = _mla_params()
    B, T = 2, 10
    x = _x(shape=(B, T, DM))
    pos = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32)
    want, _ = jax.jit(lambda p, a, q: jattn.mla_attention(p, a, q, **MLA))(
        jp, x, pos)
    full, cache = attn.mla_attention(tp, _t(x), _t(pos).long(), **MLA)
    assert cache is None
    assert _rel(full, want) < BLOCK_TOL
    # teacher-forced absorbed decode against the latent cache
    jcache = jattn.init_mla_cache(B, T, MLA["kv_lora"], MLA["rope_dim"],
                                  jnp.float32)
    cache = attn.init_mla_cache(B, T, MLA["kv_lora"], MLA["rope_dim"],
                                torch.float32, "cpu")
    jstep = jax.jit(lambda p, a, q, c, i: jattn.mla_attention(
        p, a, q, cache=c, cache_index=i, **MLA))
    for i in range(T):
        jout, jcache = jstep(jp, x[:, i:i + 1], pos[:, i:i + 1], jcache,
                             jnp.asarray(i, jnp.int32))
        out, same = attn.mla_attention(tp, _t(x[:, i:i + 1]),
                                       _t(pos[:, i:i + 1]).long(),
                                       cache=cache, cache_index=i, **MLA)
        assert same is cache                         # written in place
        assert _rel(out, jout) < BLOCK_TOL
        assert _rel(out[:, 0], full[:, i]) < DECODE_TOL
    for got, want_c in zip(cache, jcache):
        assert _rel(got, want_c) < BLOCK_TOL
    # the latent cache holds kv_lora + rope_dim floats a token and layer
    assert sum(c.shape[-1] for c in cache) == MLA["kv_lora"] + \
        MLA["rope_dim"]
    with pytest.raises(IndexError, match="capacity"):
        attn.mla_attention(tp, _t(x[:, :1]), _t(pos[:, :1]).long(),
                           cache=cache, cache_index=T, **MLA)

