"""The port's 2-D engine on two model shards, each layer's leaves gathered
whole only inside the layer loop, against the port's ``build_rollout_fn``
on one process, for tiny configs of four families with the reference's
``init_params`` weights carried across: stablelm-1.6b (dense GQA),
deepseek-v2-lite-16b (MoE with MLA and a dense first layer),
falcon-mamba-7b (Mamba) and whisper-medium (the encoder-decoder).  One
spawn of two gloo processes runs every case:

  * params, cache, losses and xis bit for bit (remat on in the engine,
    "dots" or "full"; off in the stacked run);
  * ``GATHERED["peak"]`` over one local step is the largest layer of one
    client (an encoder-decoder layer with its cross-attention) or the
    tied table, whichever is larger: one layer of one client is whole at
    a time;
  * the leafwise average a leaf piece at a time (``compressed_average``
    for one client row, ``make_client_sharded_average`` for several, on
    the size-1 clients axis, both given the engine's ``ModelCut``) equals
    the average written as one call a tree, natural and QSGD, unmasked
    and masked, also with a client whose compressed table is non-finite
    (the guarded mean), and its peak is one layer of one leaf of the
    row's clients;
  * remat off on two model shards raises.

In this process: a codec given a layer of a stacked leaf at its counter
offset compresses it as the whole leaf's call does, bit for bit (every
codec that takes offsets; rand-k and top-k refuse them); the pieces a
leaf is compressed in; the average with layer pieces and no model axis
equals the one call a tree; ``launch.dryrun`` prices mistral-large-123b's
train_4k step on 16 x 16 in bf16 at its local step (61.25 GB, was 519.4),
which outweighs its aggregation step.
"""
import dataclasses
import math

import numpy as np
import pytest

import jax
import torch

from _torch_threads import torch_one_thread  # noqa: F401
import _torch_ranks as ranks
from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro_torch.configs import get_config
from repro_torch.core import make_compressor, make_plan, prng
from repro_torch.core.aggregation import (ModelCut, _pieces,
                                          compressed_average)
from repro_torch.core.l2gd import UPDATE_CHUNK
from repro_torch.core.rollout import window_streams
from repro_torch.core.tree import spec_leaves, tree_leaves
from repro_torch.data import TokenStream
from repro_torch.launch import dryrun, sharding, steps
from repro_torch.launch.mesh import run_cpu_ranks
from repro_torch.launch.train import init_stacked_params
from repro_torch.models.model import layer_stacks

N, B, S, LENGTH, P = 2, 1, 16, 4, 0.5
#: the aggregation's case: the first family at this vocab, so that a
#: layer stack's leaf outweighs the table and its layer does not
AGG_VOCAB = 32
#: name -> (arch, changes to its reduced config, the engine's remat policy)
CASES = {
    "gqa": ("stablelm-1.6b", dict(d_model=64, d_ff=128, n_heads=4,
                                  n_kv_heads=2, head_dim=16, vocab_size=256),
            "dots"),
    "moe": ("deepseek-v2-lite-16b", dict(d_model=64, vocab_size=256), "full"),
    "mamba": ("falcon-mamba-7b", dict(d_model=64, vocab_size=256), "dots"),
    "encdec": ("whisper-medium", dict(d_model=64, d_ff=128, head_dim=16,
                                      vocab_size=256), "full"),
}


def _key_with(branches):
    """The first seed whose window of len(branches) steps runs those
    branches from the initial xi_prev = 1."""
    for seed in range(1000):
        xis = window_streams(prng.PRNGKey(seed), P, 0, len(branches))[0]
        prev, got = 1, []
        for xi in xis:
            got.append(0 if xi == 0 else (1 if prev == 0 else 2))
            prev = xi
        if got == list(branches):
            return prng.PRNGKey(seed)
    raise AssertionError(f"no seed gives {branches}")


KEY = _key_with([0, 1, 2, 0])
LOCAL_KEY = _key_with([0])


def _case(name):
    arch, changes, policy = CASES[name]
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **changes)
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    jp = jax.vmap(lambda k: jinit_params(k, jcfg))(keys)
    params = jax.tree.map(lambda a: np.array(a, np.float32), jp)
    ts = TokenStream(n_clients=N, vocab=jcfg.vocab_size, batch=B, seq=S,
                     seed=1)
    batches = {"tokens": np.stack([ts.batch_at(k) for k in range(LENGTH)])}
    if jcfg.is_encdec:
        rng = np.random.default_rng(2)
        batches["frames"] = (0.02 * rng.standard_normal(
            (LENGTH, N, B, jcfg.n_frontend_tokens, jcfg.d_model))) \
            .astype(np.float32)
    return (name, arch, changes, policy, params, batches)


@pytest.fixture(scope="module")
def runs():
    cases = [_case(name) for name in CASES]
    r0, r1 = run_cpu_ranks(ranks.mesh2d_layer_runs, 2, cases, KEY,
                           LOCAL_KEY, AGG_VOCAB)
    return r0, r1


def _cfg(name, **more):
    arch, changes, _ = CASES[name]
    return dataclasses.replace(get_config(arch).reduced(),
                               **{**changes, **more})


def _nbytes(tree, specs):
    """Bytes of the leaves of ``tree`` that the specs cut on "model"."""
    return sum(a.numel() * a.element_size()
               for a, s in zip(tree_leaves(tree), spec_leaves(specs))
               if "model" in s)


def _largest_gather(cfg):
    """max(the largest layer's model-cut leaves of one client, the
    table's): an encoder-decoder's decoder layer counts its
    cross-attention too."""
    shapes = steps.param_shapes(cfg)
    specs = sharding.param_pspecs(shapes, 2, client_axes=())
    layers = {"layers": cfg.n_layers - cfg.first_dense_layers,
              "dense_layers": cfg.first_dense_layers,
              "encoder": cfg.encoder_layers, "cross": cfg.n_layers}
    per = {g: _nbytes(shapes[g], specs[g]) // layers[g]
           for g in layer_stacks(cfg)}
    if cfg.is_encdec:
        per["layers"] += per.pop("cross")
    return max(max(per.values()), _nbytes(shapes["embed"], specs["embed"]))


@pytest.mark.parametrize("name", list(CASES))
def test_two_model_shards_bit_exact(runs, name):
    for r in runs:
        got = r[name]
        assert list(got["ref_branches"]) == [0, 1, 2, 0]
        np.testing.assert_array_equal(got["xis"], got["ref_xis"])
        np.testing.assert_array_equal(got["losses"], got["ref_losses"])
        for a, b in zip(got["params"] + got["cache"],
                        got["ref_params"] + got["ref_cache"]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # each process held its block of the model-cut leaves
    full = [a.shape for a in runs[0][name]["ref_params"]]
    local = runs[0][name]["local_shapes"]
    assert local != full
    assert all(np.prod(l) * 2 in (np.prod(f), 2 * np.prod(f))
               for l, f in zip(local, full))


@pytest.mark.parametrize("name", list(CASES))
def test_step_gathers_one_layer_of_one_client(runs, name):
    want = _largest_gather(_cfg(name))
    for r in runs:
        assert list(r[name]["local_branches"]) == [0]
        assert r[name]["step_peak"] == want


def _largest_piece(cfg, codec):
    """Bytes of the largest piece of one client's model-cut leaves: a
    layer of a stack's leaf where the codec takes its offsets, else the
    whole leaf."""
    shapes = steps.param_shapes(cfg)
    specs = sharding.param_pspecs(shapes, 2, client_axes=())
    stacks, unit, sizes = layer_stacks(cfg), codec.slice_unit(), []
    for key in shapes:
        for a, s in zip(tree_leaves(shapes[key]), spec_leaves(specs[key])):
            if "model" not in s:
                continue
            per = a.numel() // a.shape[0]
            sliced = key in stacks and unit and per % unit == 0
            sizes.append((per if sliced else a.numel()) * a.element_size())
    return max(sizes)


@pytest.mark.parametrize("codec", ["natural", "qsgd"])
@pytest.mark.parametrize("what", ["finite", "non-finite"])
@pytest.mark.parametrize("masked", [False, True])
def test_average_a_leaf_at_a_time(runs, codec, what, masked):
    cfg = _cfg("gqa", vocab_size=AGG_VOCAB)
    piece = _largest_piece(cfg, make_compressor(codec))
    shapes = steps.param_shapes(cfg)
    # a whole stacked leaf outweighs the piece: the peak tells them apart
    assert piece < max(a.numel() * a.element_size()
                       for a in tree_leaves(shapes["layers"]))
    for r in runs:
        got = r["aggregation"][(codec, what, masked)]
        assert got["equal"] and got["rows_equal"]
        # client 1's non-finite table leaves the guarded mean
        assert got["finite"]
        # the row's N clients of one piece whole at a time
        assert got["peak"] == got["rows_peak"] == N * piece


def test_remat_off_raises(runs):
    for r in runs:
        assert r["remat_off"] is not None and "remat" in r["remat_off"]


def test_dryrun_mistral_step_bytes():
    rec = dryrun.dry_run("mistral-large-123b", "train_4k", (16, 16))
    mem = rec["memory_per_process"]
    params, cache = mem["params_bytes"], mem["cache_bytes"]
    assert params == cache == 15_280_005_120
    # a layer 1,384,157,184 params, the table 402,653,184, in bf16
    gathered = 2 * 2 * (1_384_157_184 + 402_653_184)
    assert gathered == 7_147_241_472
    # the updates' float32 work on one chunk of one client's leaf
    work = 2 * UPDATE_CHUNK * 4
    # the local step: the new blocks (15.3 GB) outweigh the gathers
    local = 2 * params + cache + max(gathered, params + work)
    # the aggregation step on 16 rows of one client: the target's blocks,
    # and the table (the largest piece: 402,653,184 > 12,288 x 28,672 of
    # a layer of w_up) at four float32 copies with the 16 clients'
    # natural payloads of it (9 bits an element)
    piece = 402_653_184
    transient = 16 * piece + 16 * piece * 9 // 8
    agg = 2 * params + cache + max(params + work, transient)
    assert transient < params and agg == local == 61_254_238_208
    assert rec["engine_step_bytes_per_process"] == local
    assert rec["engine_step_bytes_per_process"] < 80e9


_X = np.random.default_rng(3).standard_normal((N, 3, 8, 256)) \
    .astype(np.float32)
CODECS = {"identity": {}, "natural": {}, "bernoulli": dict(q=0.25),
          "qsgd": dict(levels=15, bucket=512),
          "terngrad": dict(bucket=1024)}


@pytest.mark.parametrize("name", list(CODECS))
def test_codec_compresses_a_layer_at_its_offset(name):
    codec = make_compressor(name, **CODECS[name])
    keys = prng.split(prng.PRNGKey(7), N)
    x = torch.from_numpy(_X)
    per = math.prod(x.shape[2:])
    assert per % codec.slice_unit() == 0
    whole = codec.apply(keys, x)
    wire = codec.decode(codec.encode(keys, x))
    for i in range(x.shape[1]):
        layer = x[:, i:i + 1]
        got = codec.apply(keys, layer, offset=i * per)
        assert torch.equal(got.view(torch.int32),
                           whole[:, i:i + 1].view(torch.int32))
        got = codec.decode(codec.encode(keys, layer, offset=i * per))
        assert torch.equal(got.view(torch.int32),
                           wire[:, i:i + 1].view(torch.int32))


@pytest.mark.parametrize("name,offset", [("randk", 2048), ("topk", 2048),
                                         ("qsgd", 1024), ("terngrad", 7)])
def test_codec_refuses_offsets_it_cannot_take(name, offset):
    codec = make_compressor(name)
    x = torch.from_numpy(_X)[:, :1]
    with pytest.raises(ValueError, match="slice"):
        codec.encode(prng.split(prng.PRNGKey(7), N), x, offset=offset)
    if name != "qsgd":
        return
    with pytest.raises(ValueError, match="slice"):
        codec.apply(prng.split(prng.PRNGKey(7), N), x, offset=offset)


def test_pieces_of_a_leaf():
    leaf = torch.zeros((N, 3, 8, 128))     # a block of 8 x 256 a layer
    natural, qsgd = make_compressor("natural"), make_compressor("qsgd")
    layers = [(i, i * 2048) for i in range(3)]
    assert _pieces(leaf, 3, True, 2, (natural, natural)) == layers
    assert _pieces(leaf, 3, True, 2, (qsgd, natural)) == layers
    # a layer of 1,024 elements is half a QSGD bucket: the leaf whole
    assert _pieces(leaf, None, True, 2, (natural, qsgd)) == [(None, 0)]
    assert _pieces(leaf, 3, False, 2, (natural, natural)) == [(None, 0)]
    assert _pieces(leaf, 1, True, 2, (natural, natural)) == [(None, 0)]
    assert _pieces(leaf, 3, True, 2, (natural, make_compressor(
        "randk"))) == [(None, 0)]


@pytest.mark.parametrize("codec", ["natural", "qsgd", "bernoulli"])
@pytest.mark.parametrize("masked", [False, True])
def test_average_by_layers_equals_one_call(codec, masked):
    """No model axis: the layer pieces alone against the call a tree,
    with client 1's table non-finite (the guarded mean)."""
    cfg = _cfg("gqa", vocab_size=AGG_VOCAB)
    shapes = steps.param_shapes(cfg)
    params = init_stacked_params(cfg, N, 0, "cpu")
    params["embed"]["table"][1, 0, 0] = float("inf")
    plan = make_plan(make_compressor(codec, **CODECS[codec]), shapes,
                     transport="leafwise")
    leaves = tree_leaves(params)
    stacks = layer_stacks(cfg)
    cut = ModelCut(None, (None,) * len(leaves), tuple(tree_leaves(
        {k: [k in stacks] * len(tree_leaves(v)) for k, v in
         sorted(params.items())})))
    assert sum(cut.layered) == len(tree_leaves(params["layers"]))
    mask = torch.tensor([1.0, 0.0]) if masked else None
    key = prng.PRNGKey(5)
    got = compressed_average(key, params, plan, plan, mask=mask, cut=cut)
    want = ranks.whole_tree_average(key, params, plan, mask)
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(tree_leaves(got), tree_leaves(want)))
    assert all(bool(torch.isfinite(a).all()) for a in tree_leaves(got))
