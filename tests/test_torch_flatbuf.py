"""Parity of the port's flat-buffer engine, codec plans and aggregation
layer with the JAX reference (repro.core.flatbuf / codec / aggregation).

Shape and bookkeeping results (layouts, offsets, the 124 -> 128 clamp,
wire bits, key schedules) are exact.  Compressed values follow the
layered rule of tests/test_torch_qsgd.py: bucket norms agree within a few
ulps, and wherever a bucket's norm agrees exactly its codes do too.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_threads import torch_one_thread  # noqa: F401
from repro.core import aggregation as jagg
from repro.core import codec as jcodec
from repro.core import compressors as jcomp
from repro.core import flatbuf as jfb
from repro_torch.convert import key_from_words, params_from_numpy
from repro_torch.core import aggregation as tagg
from repro_torch.core import codec as tcodec
from repro_torch.core import compressors as tcomp
from repro_torch.core import flatbuf as tfb
from repro_torch.core.tree import tree_leaves

NORM_ULPS = 4


def _tree(kind, rng, n=None):
    lead = () if n is None else (n,)
    if kind == "logreg":
        return {"w": rng.normal(size=lead + (124,)).astype(np.float32)}
    if kind == "multi":
        return {"b": rng.normal(size=lead + (7,)).astype(np.float32),
                "a": {"k": rng.normal(size=lead + (30, 50)).astype(np.float32),
                      "s": rng.normal(size=lead + (1000,)).astype(np.float32)}}
    return {"z": np.zeros(lead + (300,), np.float32)}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_tree_equal(got, want):
    gl, wl = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", ["logreg", "multi", "zeros"])
@pytest.mark.parametrize("bucket", [128, 2048])
def test_layout_and_ravel_exact(kind, bucket):
    tree = _tree(kind, np.random.default_rng(0))
    jl = jfb.layout_of(_jax(tree), bucket)
    tl = tfb.layout_of(params_from_numpy(tree), bucket)
    assert (tl.shapes, tl.offsets, tl.d, tl.n_buckets, tl.padded, tl.pad) \
        == (jl.shapes, jl.offsets, jl.d, jl.n_buckets, jl.padded, jl.pad)
    flat = tfb.ravel(tl, params_from_numpy(tree))
    np.testing.assert_array_equal(flat.numpy(),
                                  np.asarray(jfb.ravel(jl, _jax(tree))))
    x2d = tfb.bucketize(flat, bucket)
    np.testing.assert_array_equal(
        x2d.numpy(), np.asarray(jfb.bucketize(jfb.ravel(jl, _jax(tree)),
                                              bucket)))
    _assert_tree_equal(tfb.unravel(tl, tfb.unbucketize(x2d, tl.d)),
                       jfb.unravel(jl, jfb.ravel(jl, _jax(tree))))


def test_stacked_ravel_is_per_client_ravel():
    tree = _tree("multi", np.random.default_rng(1), n=3)
    t = params_from_numpy(tree)
    layout = tfb.layout_of(t, 2048, batch_dims=1)
    flat = tfb.ravel(layout, t)
    assert flat.shape == (3, layout.d)
    for i in range(3):
        one = jax.tree.map(lambda a: jnp.asarray(a[i]), tree)
        np.testing.assert_array_equal(
            flat[i].numpy(), np.asarray(jfb.ravel(jfb.layout_of(one), one)))


@pytest.mark.parametrize("d,want", [(124, 128), (128, 128), (129, 256),
                                    (2047, 2048), (2048, 2048), (5000, 2048),
                                    (0, 2048)])
def test_clamp_bucket_exact(d, want):
    assert tfb._clamp_bucket(2048, d) == jfb._clamp_bucket(2048, d) == want


@pytest.mark.parametrize("kind", ["logreg", "multi", "zeros"])
@pytest.mark.parametrize("codec,transport", [
    ("identity", None), ("qsgd", None), ("qsgd", "flat"), ("qsgd", "packed")])
def test_round_bits_exact(codec, transport, kind):
    tree = _tree(kind, np.random.default_rng(2))
    jp = jcodec.make_plan(jcomp.make_compressor(codec), _jax(tree),
                          transport=transport)
    tp = tcodec.make_plan(tcomp.make_compressor(codec),
                          params_from_numpy(tree), transport=transport)
    assert tp.transport == jp.transport
    assert tp.round_bits() == jp.round_bits()


def test_round_bits_logreg_value():
    """124 values clamp to one 128-code bucket: 128 * 8 + 32 bits."""
    plan = tcodec.make_plan(tcomp.QSGD(), {"w": torch.zeros(124)})
    assert plan.round_bits() == 1056.0


@pytest.mark.parametrize("kind", ["logreg", "multi"])
@pytest.mark.parametrize("levels", [7, 127])
def test_pack_tree_layered_and_unpack_exact(kind, levels):
    tree = _tree(kind, np.random.default_rng(3))
    key = jax.random.PRNGKey(4)
    jpay, _ = jfb.pack_tree_qsgd(key, _jax(tree), levels=levels)
    tpay, _ = tfb.pack_tree_qsgd(key_from_words(np.asarray(key)),
                                 params_from_numpy(tree), levels=levels)
    jn, tn = np.asarray(jpay.norms), tpay.norms.numpy()
    assert tpay.codes.shape == jpay.codes.shape
    assert tpay.nbits == jpay.nbits
    ulps = np.abs(jn - tn) / np.spacing(np.maximum(jn, 1e-30))
    assert ulps.max() <= NORM_ULPS
    same = (jn == tn)[:, 0]
    np.testing.assert_array_equal(tpay.codes.numpy()[same],
                                  np.asarray(jpay.codes)[same])
    # decoding identical payloads is bit-exact
    given = tcodec.QSGDPayload(torch.from_numpy(np.array(jpay.codes)),
                               torch.from_numpy(np.array(jpay.norms)),
                               levels=levels, layout=tpay.layout)
    _assert_tree_equal(tfb.unpack_tree(given), jfb.unpack_tree(jpay))


@pytest.mark.parametrize("kind", ["logreg", "multi", "zeros"])
def test_flat_apply_is_unpack_of_pack(kind):
    """Flat and packed transports decode to the same bits (kernel
    invariant), and stay within one level of the reference."""
    tree = _tree(kind, np.random.default_rng(5))
    words = np.asarray(jax.random.PRNGKey(6))
    comp = tcomp.QSGD(levels=15)
    t = params_from_numpy(tree)
    flat = tcodec.make_plan(comp, transport="flat").apply(words, t)
    packed = tcodec.make_plan(comp, transport="packed").apply(words, t)
    for a, b in zip(tree_leaves(flat), tree_leaves(packed)):
        assert torch.equal(a, b)
    want = jfb.flat_tree_apply(jcomp.QSGD(levels=15), jnp.asarray(words),
                               _jax(tree))
    jpay, _ = jfb.pack_tree_qsgd(jnp.asarray(words), _jax(tree), levels=15)
    step = float(np.asarray(jpay.norms).max()) / 15 if tree_leaves(t) \
        else 0.0
    for a, b in zip(tree_leaves(flat), jax.tree_util.tree_leaves(want)):
        assert np.max(np.abs(a.numpy() - np.asarray(b)), initial=0) \
            <= step * (1 + 1e-6)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_reduce_payload_mean_parity(n):
    """The server's one-pass mean of identical stacked payloads, with a
    poisoned client: excluded from numerator and denominator on both
    sides; bit-exact for one client, within n accumulator roundings
    otherwise (XLA:CPU's FMA contraction, tests/test_torch_qsgd.py)."""
    rng = np.random.default_rng(7 + n)
    tree = _tree("multi", rng, n=n)
    keys = jax.random.split(jax.random.PRNGKey(8), n)
    plan = jcodec.make_plan(jcomp.QSGD(levels=7), transport="packed")
    jpay = jax.vmap(plan.encode)(keys, _jax(tree))
    if n > 1:
        norms = np.array(jpay.norms)
        norms[1, 0, 0] = np.nan
        jpay = jpay.__class__(jpay.codes, jnp.asarray(norms),
                              levels=jpay.levels, layout=jpay.layout)
    tl = tfb.layout_of(params_from_numpy(tree), 2048, batch_dims=1)
    tl = tfb.layout_of(params_from_numpy(tree), tfb._clamp_bucket(2048, tl.d),
                       batch_dims=1)
    tpay = tcodec.QSGDPayload(torch.from_numpy(np.array(jpay.codes)),
                              torch.from_numpy(np.array(jpay.norms)),
                              levels=7, layout=tl)
    np.testing.assert_array_equal(tfb.payload_finite_mask(tpay).numpy(),
                                  np.asarray(jfb.payload_finite_mask(jpay)))
    got = tfb.reduce_payload_mean(tpay)
    want = jfb.reduce_payload_mean(jpay)
    if n == 1:
        _assert_tree_equal(got, want)
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert np.all(np.isfinite(a.numpy()))
        bound = n * np.spacing(np.float32(np.abs(np.asarray(b)).max() * n))
        assert np.max(np.abs(a.numpy() - np.asarray(b))) <= bound


def test_compressed_average_identity_exact():
    """Identity uplink and downlink: the key schedule is irrelevant and
    the mean is the reference's jnp.mean bit for bit."""
    rng = np.random.default_rng(9)
    tree = _tree("multi", rng, n=5)
    key = jax.random.PRNGKey(10)
    want = jagg.compressed_average(key, _jax(tree), jcomp.Identity(),
                                   jcomp.Identity())
    got = tagg.compressed_average(np.asarray(key), params_from_numpy(tree),
                                  tcomp.Identity(), tcomp.Identity())
    _assert_tree_equal(got, want)


@pytest.mark.parametrize("uplink", ["flat", "packed"])
def test_compressed_average_qsgd_close(uplink):
    """QSGD both ways under the same key schedule: within one downlink
    level plus the uplink's accumulated rounding of the reference."""
    rng = np.random.default_rng(11)
    tree = _tree("logreg", rng, n=4)
    key = jax.random.PRNGKey(12)
    jup = jcodec.make_plan(jcomp.QSGD(), transport=uplink)
    tup = tcodec.make_plan(tcomp.QSGD(), transport=uplink)
    want = jagg.compressed_average(key, _jax(tree), jup, jcomp.QSGD())
    got = tagg.compressed_average(np.asarray(key), params_from_numpy(tree),
                                  tup, tcomp.QSGD())
    mean = np.abs(np.mean(tree["w"], axis=0))
    step = np.sqrt(np.sum(mean ** 2)) * 2 / 127
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               rtol=0, atol=step)


def test_masked_client_mean_and_finite_mask():
    rng = np.random.default_rng(13)
    tree = _tree("multi", rng, n=4)
    tree["b"][2, 3] = np.inf
    mask = np.array([1, 0, 1, 1], np.float32)
    np.testing.assert_array_equal(
        tagg.stacked_finite_mask(params_from_numpy(tree)).numpy(),
        np.asarray(jagg.stacked_finite_mask(_jax(tree))))
    clean = _tree("multi", rng, n=4)
    got = tagg.masked_client_mean(params_from_numpy(clean),
                                  torch.from_numpy(mask))
    want = jagg.masked_client_mean(_jax(clean), jnp.asarray(mask))
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    w = torch.tensor([1.0, 2.0, 0.0, 1.0])   # the Inf client weighs 0
    s = tagg.weighted_client_sum(params_from_numpy(tree), w)
    assert all(np.all(np.isfinite(a.numpy())) for a in tree_leaves(s))


def test_unported_transports_raise():
    """Every transport of the reference is ported: leafwise QSGD, the
    narrow wire and natural compression build; what still raises is what
    the reference refuses too."""
    assert tcodec.make_plan(tcomp.QSGD(), transport="leafwise").transport \
        == "leafwise"
    assert tcodec.make_plan(tcomp.QSGD(levels=7), narrow=True).narrow
    assert tcodec.make_plan(tcomp.make_compressor("natural")).transport \
        == "flat"
    with pytest.raises(ValueError):
        tcodec.make_plan(tcomp.QSGD(), narrow=True)          # levels 127
    with pytest.raises(ValueError):
        tcomp.make_compressor("nope")
    plan = tcodec.make_plan(tcomp.Identity(), {"w": torch.zeros(3)})
    assert plan.transport == "leafwise" and plan.round_bits() == 96.0
    x = {"w": torch.arange(3.0)}
    assert torch.equal(plan.decode(plan.encode(np.zeros(2, np.uint32), x))
                       ["w"], x["w"])
