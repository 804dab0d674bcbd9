"""The 2-D engine's Megatron split on two model shards (each process runs
its block of every product whose cut falls on whole heads, experts or
channels), on tiny configs of five families with the reference's
``init_params`` weights carried across: stablelm-1.6b (dense GQA),
deepseek-v2-lite-16b (MoE with MLA and a dense first layer),
falcon-mamba-7b (Mamba), whisper-medium (the encoder-decoder) and
hymba-1.5b with 5 heads (a hybrid whose attention does not split, so its
leaves are gathered, and whose table of 257 rows stays whole); and
gemma3-1b, whose one kv head does not split (``wk`` / ``wv`` gathered,
their gradients summed over the axis, as mistral-large-123b's 8 kv heads
on 16 model shards) and whose qk-norm scales enter the heads' blocks.
One spawn of two gloo processes runs every case:

  * one local step's gradient blocks equal the blocks of the one-process
    gradient within rtol 1e-5 / atol 1e-6 (the gradient traps: the
    partial gradients of Mamba's (dt_low, B, C), of the MoE combine
    weights, of the qk-norm scales and of the gathered kv projections,
    summed over the model axis before they reach a weight);
  * a 4-step rollout (branches [0, 1, 2, 0], natural both ways) against
    the reference's ``build_rollout_fn`` in this process: xis equal,
    params within the reference's own rtol 1e-5 / atol 1e-6
    (tests/test_mesh2d.py:349) outside at most FLIP_BOUND elements;
  * every leaf the model axis leaves whole (norms, the router, MLA's
    ``w_dkv``, a table whose vocab does not divide) ends with the same
    bits on both ranks;
  * ``GATHERED`` over one local step counts only the leaves that fall
    back (the hybrid's attention, gemma3's kv projections; none in the
    other families), ``REDUCED`` the region functions' sums and maxima
    and the gathered leaves' gradient sums, each as worked out from the
    shapes;
  * *f*, *g*, the vocab-parallel embedding and loss match one process's
    values and gradients, and are the identity on one model shard.

In this process: which leaves the split gathers at full size, remat
required only where a layer gathers, and ``launch.dryrun``'s FLOPs a
process for mistral-large-123b's train_4k on 16 x 16 (the kv heads fall
back at 16 model shards) against a figure from the shapes.
"""
import concurrent.futures
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _torch_threads import torch_one_thread  # noqa: F401
import _torch_ranks as ranks
from repro.configs import get_config as jget_config
from repro.core import L2GDHyper as JHyper
from repro.core import init_state as jinit_state
from repro.core import make_compressor as jmake
from repro.launch import steps as jsteps
from repro.models import init_params as jinit_params
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.core import prng
from repro_torch.core.rollout import window_streams
from repro_torch.data import TokenStream
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import run_cpu_ranks
from repro_torch.launch.roofline import analytic_flops

N, B, S, LENGTH, P, WORLD = 2, 1, 16, 4, 0.5, 2
RTOL, ATOL = 1e-5, 1e-6
#: elements of the params allowed outside RTOL / ATOL after the rollout.
#: Only a stochastic codec's decision turns an ulp-level difference into
#: one outside them: natural rounds an element to the other power of two
#: when its input moves across the draw, with a chance of about the
#: input's relative error (some 1e-6 here) a compressed element; the
#: rollout compresses the two clients' and the mean's params once (3 x
#: 1e5 to 3 x 9e5 elements a case), a Poisson mean of at most 1, and
#: five of its standard deviations beside it.  None flips at these seeds
#: (the largest difference is 0.16 of RTOL / ATOL).
FLIP_BOUND = 6
#: name -> (arch, changes to its reduced config, the engine's remat policy)
CASES = {
    "gqa": ("stablelm-1.6b", dict(d_model=64, d_ff=128, n_heads=4,
                                  n_kv_heads=2, head_dim=16, vocab_size=256),
            "dots"),
    "moe": ("deepseek-v2-lite-16b", dict(d_model=64, vocab_size=256), "full"),
    "mamba": ("falcon-mamba-7b", dict(d_model=64, vocab_size=256), "dots"),
    "encdec": ("whisper-medium", dict(d_model=64, d_ff=128, head_dim=16,
                                      vocab_size=256), "full"),
    "hybrid": ("hymba-1.5b", dict(d_model=64, d_ff=128, n_heads=5,
                                  n_kv_heads=5, head_dim=16, vocab_size=257),
               "dots"),
    "gqa_kv": ("gemma3-1b", dict(d_model=64, d_ff=128, head_dim=16,
                                 vocab_size=256), "full"),
}


def _seed_with(branches):
    """The first seed whose window of len(branches) steps runs those
    branches from the initial xi_prev = 1."""
    for seed in range(1000):
        xis = window_streams(prng.PRNGKey(seed), P, 0, len(branches))[0]
        prev, got = 1, []
        for xi in xis:
            got.append(0 if xi == 0 else (1 if prev == 0 else 2))
            prev = xi
        if got == list(branches):
            return seed
    raise AssertionError(f"no seed gives {branches}")


SEED = _seed_with([0, 1, 2, 0])
LOCAL_SEED = _seed_with([0])


def _jcfg(name):
    arch, changes, _ = CASES[name]
    return dataclasses.replace(jget_config(arch).reduced(), **changes)


def _cfg(name):
    arch, changes, _ = CASES[name]
    return dataclasses.replace(get_config(arch).reduced(), **changes)


def _problem(name):
    jcfg = _jcfg(name)
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    jp = jax.vmap(lambda k: jinit_params(k, jcfg))(keys)
    ts = TokenStream(n_clients=N, vocab=jcfg.vocab_size, batch=B, seq=S,
                     seed=1)
    batches = {"tokens": np.stack([ts.batch_at(k) for k in range(LENGTH)])}
    if jcfg.is_encdec:
        rng = np.random.default_rng(2)
        batches["frames"] = (0.02 * rng.standard_normal(
            (LENGTH, N, B, jcfg.n_frontend_tokens, jcfg.d_model))) \
            .astype(np.float32)
    return jp, batches


@pytest.fixture(scope="module")
def results():
    """(the ranks' results, the reference's rollout a case): the
    reference runs here while the two ranks run."""
    problems = {name: _problem(name) for name in CASES}
    cases = []
    for name, (jp, batches) in problems.items():
        arch, changes, policy = CASES[name]
        params = jax.tree.map(lambda a: np.array(a, np.float32), jp)
        cases.append((name, arch, changes, policy, params, batches))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(run_cpu_ranks, ranks.mesh2d_split_runs, WORLD,
                              cases, prng.PRNGKey(SEED),
                              prng.PRNGKey(LOCAL_SEED))
        refs = {name: _reference(name, *problems[name]) for name in CASES}
        return spawned.result(), refs


@pytest.fixture(scope="module")
def runs(results):
    return results[0]


def _reference(name, jp, batches):
    """The reference's build_rollout_fn on one process: (xis, branches,
    params leaves, cache leaves)."""
    jhp = JHyper(eta=jnp.asarray(0.1, jnp.float32),
                 lam=jnp.asarray(0.5, jnp.float32),
                 p=jnp.asarray(P, jnp.float32), n=N)
    jst, jtr = jsteps.build_rollout_fn(
        _jcfg(name), jhp, jmake("natural"), jmake("natural"),
        length=LENGTH, donate=False)(
            jinit_state(jp), jax.tree.map(jnp.asarray, batches),
            jax.random.key_data(jax.random.PRNGKey(SEED)))
    return (np.asarray(jtr.xis), np.asarray(jtr.branches),
            [np.asarray(a) for a in jax.tree.leaves(jst.params)],
            [np.asarray(a) for a in jax.tree.leaves(jst.cache)])


def _outside(got, want):
    """Elements of ``got`` outside RTOL / ATOL of ``want``."""
    return int(np.sum(~np.isclose(got, want, rtol=RTOL, atol=ATOL)))


@pytest.mark.parametrize("name", list(CASES))
def test_gradient_blocks_match_one_process(runs, name):
    for r in runs:
        got, want = r[name]["grads"], r[name]["want_grads"]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", list(CASES))
def test_rollout_matches_reference(results, name):
    runs, refs = results
    xis, branches, params, cache = refs[name]
    assert list(branches) == [0, 1, 2, 0]
    flips = 0
    for r in runs:
        got = r[name]
        np.testing.assert_array_equal(got["xis"], xis)
        np.testing.assert_array_equal(got["branches"], branches)
        assert np.all(np.isfinite(got["losses"]))
        assert len(got["params"]) == len(params)
        for a, b in zip(got["params"] + got["cache"], params + cache):
            assert a.shape == b.shape and a.dtype == b.dtype
            flips += _outside(a, b)
    assert flips <= FLIP_BOUND


@pytest.mark.parametrize("name", list(CASES))
def test_replicated_leaves_bit_equal_across_ranks(runs, name):
    one, two = (r[name]["replicated"] for r in runs)
    assert len(one) == len(two) > 0
    for a, b in zip(one, two):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def _reduces(cfg):
    """One client's local step (remat on, every layer's forward
    recomputed whole): (bytes of each reduce outside the layers, of each
    a layer's forward runs, of each the backward runs), float32."""
    T, d, f4 = B * S, cfg.d_model, 4
    act = T * d * f4
    outside, fwd, bwd = [], [], []
    if cfg.vocab_size % WORLD == 0:          # the table's vocab block
        # the embedding's g; the loss's max, its sums of exponentials and
        # target logits stacked
        outside = [act, (T - 1) * f4, 2 * (T - 1) * f4]
        bwd.append(act)                      # f before the unembedding
    dbc = T * (max(d // 16, 1) + 2 * cfg.ssm_state) * f4
    dense = cfg.first_dense_layers
    for i in range(cfg.n_layers):
        if cfg.mixer == "mla":
            fwd += [act]
            bwd += [act, T * cfg.kv_lora_rank * f4, T * cfg.mla_rope_dim * f4]
        if cfg.mixer in ("mamba", "hybrid"):
            fwd += [dbc, act]
            bwd += [act, dbc]
        if cfg.mixer == "gqa":
            fwd += [act] * (2 if cfg.is_encdec else 1)
            bwd += [act] * (2 if cfg.is_encdec else 1)
            if cfg.n_kv_heads % WORLD:       # wk, wv's gradients summed
                bwd += [leaf for leaf in _gathers(cfg)]
            if cfg.qk_norm:                  # the q and k norms' scales
                bwd += [cfg.hd * f4] * 2
        if cfg.is_encdec:                    # the cross-attention's inputs
            bwd += [B * cfg.n_frontend_tokens * d * f4]
        if cfg.ffn == "moe" and i >= dense:
            fwd += [act]
            bwd += [act, T * cfg.experts_per_token * f4]
        elif cfg.ffn != "none":
            fwd += [act]
            bwd += [act]
    enc = B * cfg.n_frontend_tokens * d * f4
    for _ in range(cfg.encoder_layers):
        fwd += [enc, enc]
        bwd += [enc, enc]
    return outside, fwd, bwd


def _gathers(cfg):
    """Bytes of each leaf one layer's forward gathers whole: the hybrid's
    attention (5 heads do not split on 2 shards), gemma3's wk and wv (its
    one kv head does not)."""
    d, hd, H, kv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    if cfg.mixer == "hybrid":
        return [d * H * hd * 4, d * kv * hd * 4, d * kv * hd * 4,
                H * hd * d * 4]
    if cfg.mixer == "gqa" and kv % WORLD:
        return [d * kv * hd * 4] * 2
    return []


@pytest.mark.parametrize("name", list(CASES))
def test_gathers_and_reduces_from_shapes(runs, name):
    cfg = _cfg(name)
    outside, fwd, bwd = _reduces(cfg)
    sizes = outside + 2 * fwd + bwd
    gathers = 2 * cfg.n_layers * _gathers(cfg)
    for r in runs:
        got = r[name]
        assert list(got["local_branches"]) == [0]
        assert got["reduced"] == (N * len(sizes), N * WORLD * sum(sizes))
        assert got["gathered"] == (N * len(gathers), N * sum(gathers))


def test_split_gathers_only_leaves_off_whole_heads():
    gathered = steps.split_gathers(_cfg("hybrid"), WORLD)
    assert all(gathered["layers"]["attn"].values())
    assert not any(a for k, v in gathered["layers"].items() if k != "attn"
                   for a in (v.values() if isinstance(v, dict) else [v]))
    for name in ("gqa", "moe", "mamba", "encdec"):
        tree = steps.split_gathers(_cfg(name), WORLD)
        assert not any(_leaves(tree))
    tree = steps.split_gathers(_cfg("gqa_kv"), WORLD)
    assert [k for k, v in tree["layers"]["attn"].items() if v is True] \
        == ["wk", "wv"]
    # mistral-large-123b at 16 model shards: 8 kv heads fall back
    big = steps.split_gathers(get_config("mistral-large-123b"), 16)
    assert [k for k, v in big["layers"]["attn"].items() if v is True] \
        == ["wk", "wv"]
    assert not steps.split_gathers(get_config("mistral-large-123b"),
                                   8)["layers"]["attn"]["wk"]


def _leaves(tree):
    return [a for v in tree.values()
            for a in (_leaves(v) if isinstance(v, dict) else [v])]


def test_remat_required_only_where_a_layer_gathers():
    assert not steps.lacks_remat(_cfg("gqa"), WORLD)
    assert steps.lacks_remat(_cfg("gqa"), WORLD, gather_layers=True)
    assert steps.lacks_remat(_cfg("hybrid"), WORLD)
    assert not steps.lacks_remat(dataclasses.replace(_cfg("hybrid"),
                                                     remat=True), WORLD)
    assert not steps.lacks_remat(_cfg("hybrid"), 1)


@pytest.mark.parametrize("check", ["f", "g", "embed", "one"])
def test_region_functions_exact(runs, check):
    for r in runs:
        assert r["regions"][check] is True


@pytest.mark.parametrize("check", ["fg", "loss"])
def test_region_functions_match_one_process(runs, check):
    for r in runs:
        for got, want in r["regions"][check]:
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_dryrun_mistral_flops_per_process():
    cfg = dryrun.production_cfg(get_config("mistral-large-123b"))
    shape = INPUT_SHAPES["train_4k"]
    rec = dryrun.dry_run("mistral-large-123b", "train_4k", (16, 16))
    flops = analytic_flops(cfg, shape, dryrun.n_params_active(cfg))
    assert rec["flops"]["analytic_global"] == flops
    # the kv projections: 2 x tokens x d x 2 x 8 x 128 a layer, x 3 for
    # the backward; at 16 shards each runs the one kv head of its 6 query
    # heads (group 12), an eighth of its row's, not a sixteenth
    tokens = 256 * 4096
    kv = 3 * 2.0 * tokens * 88 * 12288 * 2 * 8 * 128
    want = (flops - kv) / 256 + kv / 16 / 8
    assert rec["flops"]["analytic_per_process"] == pytest.approx(want,
                                                                 rel=1e-12)
    assert rec["flops"]["analytic_per_process"] > flops / 256
    # the products by their shares of a row: every other one splits
    terms = dryrun.flop_terms(cfg, shape, 16)
    assert sum(f for _, f, _ in terms) == pytest.approx(flops, rel=1e-12)
    assert {w: s for w, _, s in terms if s != 1 / 16} == {"attn k, v":
                                                          1 / 8}


@pytest.mark.parametrize("arch", ["hymba-1.5b", "deepseek-v2-lite-16b",
                                  "whisper-medium", "falcon-mamba-7b"])
def test_dryrun_flop_terms_sum_to_the_analytic_figure(arch):
    cfg = dryrun.production_cfg(get_config(arch))
    shape = INPUT_SHAPES["train_4k"]
    terms = dryrun.flop_terms(cfg, shape, 16)
    assert all(f >= 0 and 1 / 16 <= s <= 1 for _, f, s in terms)
    flops = analytic_flops(cfg, shape, dryrun.n_params_active(cfg))
    assert sum(f for _, f, _ in terms) == pytest.approx(flops, rel=1e-12)
