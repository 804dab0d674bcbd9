"""Parity of the port's leafwise transport with the JAX reference: the
device-side threefry draws and ``permutation``, every compressor of the
paper's Table I as a per-leaf codec, exact ``round_bits`` for every codec
and transport, the narrow QSGD wire, plan persistence, the leafwise
uplink of ``compressed_average`` and compressed L2GD run leafwise.

The reference's codecs run under ``jax.jit`` here, as they do inside its
L2GD step: compiled, XLA:CPU divides by a constant (``x / q``,
``norm / levels``) as a multiply by the float32 reciprocal, which the
port mirrors; a division by a runtime value (``|x| / max``) stays an IEEE
division on both sides.  With that, payloads and decodes are bit-exact,
except for QSGD's bucket norms: a float sum in another order, held by
the layered rule of tests/test_torch_qsgd.py (norms within NORM_ULPS;
codes equal wherever the norms are; decode exact given the same payload).
Natural inputs avoid subnormals: the jitted reference passes them
through under denormals-are-zero, the port rounds them
(tests/test_torch_natural.py pins that rule).

End-to-end runs hold xi traces, ledgers and branch counts exact, params
within RUN_ULPS units in the last place of the largest parameter and
losses within 1e-5 relative (the reference's FMA-contracted updates,
tests/test_torch_l2gd.py).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_threads import torch_one_thread  # noqa: F401
from repro.core import L2GDHyper as JHyper
from repro.core import aggregation as jagg
from repro.core import codec as jcodec
from repro.core import compressors as jcomp
from repro.core import flatbuf as jfb
from repro.data import logreg_loss_and_grad as jlogreg
from repro.data import make_logreg_data
from repro.fl import run_l2gd as jrun
from repro_torch.convert import params_from_numpy
from repro_torch.core import L2GDHyper, prng
from repro_torch.core import aggregation as tagg
from repro_torch.core import codec as tcodec
from repro_torch.core import compressors as tcomp
from repro_torch.core import flatbuf as tfb
from repro_torch.core.tree import tree_leaves
from repro_torch.data import logreg_loss_and_grad
from repro_torch.fl import run_l2gd

U32 = np.uint32
NORM_ULPS = 4
RUN_ULPS = 16
NAMES = ["identity", "qsgd", "natural", "terngrad", "bernoulli", "randk",
         "topk"]
# (name, kwargs) of every codec configuration compared payload by payload
CODECS = [
    ("identity", {}), ("qsgd", {}), ("qsgd", {"levels": 7, "bucket": 512}),
    ("qsgd", {"levels": 300, "bucket": 512}), ("natural", {}),
    ("terngrad", {}), ("terngrad", {"bucket": 100}), ("bernoulli", {}),
    ("bernoulli", {"q": 0.3}), ("randk", {}), ("randk", {"fraction": 0.37}),
    ("topk", {}), ("topk", {"fraction": 0.5}),
]
WIRE_FIELDS = ("values", "codes", "norms", "exps", "signs", "scales", "mask",
               "indices")


def _keys(n, seed=7):
    return jax.random.split(jax.random.PRNGKey(seed), n)


# --------------------------------------------------------------------------
# device-side threefry draws
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(), (7,), (3, 5), (2, 4, 33)])
def test_tensor_draws_equal_numpy_and_jax(shape):
    for k in np.asarray(_keys(6, seed=1)):
        bits = prng.tensor_bits(k, shape)
        assert bits.dtype == torch.int64 and tuple(bits.shape) == shape
        np.testing.assert_array_equal(bits.numpy().astype(U32),
                                      prng.random_bits(k, shape))
        np.testing.assert_array_equal(prng.tensor_uniform(k, shape).numpy(),
                                      prng.uniform(k, shape))
        np.testing.assert_array_equal(
            prng.tensor_uniform(k, shape).numpy(),
            np.asarray(jax.random.uniform(k, shape)))


@pytest.mark.parametrize("p", [0.1, 0.25, 0.3])
def test_batched_draws_equal_vmap(p):
    keys = _keys(5, seed=2)
    np.testing.assert_array_equal(
        prng.tensor_uniform(np.asarray(keys), (4, 9)).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (4, 9)))(keys)))
    np.testing.assert_array_equal(
        prng.tensor_bernoulli(np.asarray(keys), p, (60,)).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.bernoulli(k, p, (60,)))(
            keys)))
    np.testing.assert_array_equal(
        prng.split(np.asarray(keys), 3),
        np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(keys)))


@pytest.mark.parametrize("d", [0, 1, 7, 124, 1625, 1626, 5000])
def test_permutation_exact(d):
    """One sort round up to d = 1625, two beyond; single and batched."""
    for k in np.asarray(_keys(4, seed=d)):
        np.testing.assert_array_equal(prng.permutation(k, d).numpy(),
                                      np.asarray(jax.random.permutation(k, d)))
    keys = _keys(3, seed=d + 1)
    np.testing.assert_array_equal(
        prng.permutation(np.asarray(keys), d).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.permutation(k, d))(keys)))


# --------------------------------------------------------------------------
# the per-leaf codecs
# --------------------------------------------------------------------------

def _leaf(n=3, d=2000, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[0, :300] = 0.0                      # a zero bucket
    x[1, 10:20] = x[1, 9]                 # ties for top-k
    x[2, 5] = -x[2, 6]
    return x


def _payload_arrays(p):
    return {f: getattr(p, f) for f in WIRE_FIELDS
            if getattr(p, f, None) is not None}


@pytest.mark.parametrize("name,kw", CODECS)
def test_codec_payloads_and_decode_match_jitted_reference(name, kw):
    x = _leaf()
    keys = _keys(3)
    jc, tc = jcomp.make_compressor(name, **kw), tcomp.make_compressor(name,
                                                                      **kw)
    jp = jax.jit(jax.vmap(jc.encode))(keys, jnp.asarray(x))
    tp = tc.encode(np.asarray(keys), torch.from_numpy(x))
    assert type(tp).__name__ == type(jp).__name__
    assert tp.shape == (2000,) and tp.nbits == 3 * jp.nbits / 3
    want, got = _payload_arrays(jp), _payload_arrays(tp)
    assert set(want) == set(got)
    same = None
    if name == "qsgd":
        jn, tn = np.asarray(jp.norms), tp.norms.numpy()
        assert np.max(np.abs(jn - tn) / np.spacing(jn)) <= NORM_ULPS
        same = np.repeat((jn == tn)[..., 0], kw.get("bucket", 2048),
                         axis=-1)[:, :2000]
        del want["norms"], got["norms"]
        assert tp.codes.dtype == (torch.int16 if kw.get("levels", 127) > 127
                                  else torch.int8)
    for f in want:
        w, g = np.asarray(want[f]), got[f].numpy()
        assert g.shape == w.shape, f
        if same is not None:
            np.testing.assert_array_equal(g[same], w[same])
        else:
            np.testing.assert_array_equal(g, w)
    # decode: bit-exact from the reference's own payload
    given = tp if name != "qsgd" else dataclasses.replace(
        tp, codes=torch.from_numpy(np.array(jp.codes)),
        norms=torch.from_numpy(np.array(jp.norms)))
    np.testing.assert_array_equal(
        tc.decode(given).numpy(),
        np.asarray(jax.jit(jax.vmap(jc.decode))(jp)))


@pytest.mark.parametrize("name,kw", CODECS)
def test_apply_is_decode_of_encode_and_batched_is_per_client(name, kw):
    x = torch.from_numpy(_leaf(seed=3).reshape(3, 40, 50))
    keys = np.asarray(_keys(3, seed=4))
    tc = tcomp.make_compressor(name, **kw)
    y = tc.apply(keys, x)
    assert y.shape == x.shape and y.dtype == x.dtype
    np.testing.assert_array_equal(y.numpy(),
                                  tc.decode(tc.encode(keys, x)).numpy())
    for i in range(3):
        np.testing.assert_array_equal(y[i].numpy(),
                                      tc.apply(keys[i], x[i]).numpy())
    if name != "qsgd":
        jc = jcomp.make_compressor(name, **kw)
        want = jax.jit(jax.vmap(jc.apply))(jnp.asarray(keys),
                                           jnp.asarray(x.numpy()))
        np.testing.assert_array_equal(y.numpy(), np.asarray(want))


def test_codecs_keep_dtype_and_handle_empty_leaves():
    for name in NAMES:
        tc = tcomp.make_compressor(name)
        k = prng.PRNGKey(0)
        x = torch.linspace(-1, 1, 24, dtype=torch.float64).reshape(4, 6)
        assert tc.apply(k, x).dtype == torch.float64
        empty = torch.zeros((0, 3))
        p = tc.encode(k, empty)
        assert p.nbits == 0.0
        assert tc.decode(p).shape == (0, 3)


def test_registry_omega_and_wire_bits_match_reference():
    assert sorted(tcomp._REGISTRY) == sorted(jcomp._REGISTRY)
    for name in NAMES:
        jc, tc = jcomp.make_compressor(name), tcomp.make_compressor(name)
        for shape in [(124,), (30, 50), (5000,)]:
            assert tc.omega(shape) == jc.omega(shape)
            assert tc.wire_bits(shape) == jc.wire_bits(shape)
    with pytest.raises(ValueError):
        tcomp.make_compressor("nope")


# --------------------------------------------------------------------------
# round_bits, the narrow wire, plan persistence
# --------------------------------------------------------------------------

def _tree(kind, rng, n=None):
    lead = () if n is None else (n,)
    if kind == "logreg":
        return {"w": rng.normal(size=lead + (124,)).astype(np.float32)}
    if kind == "multi":
        return {"b": rng.normal(size=lead + (7,)).astype(np.float32),
                "a": {"k": rng.normal(size=lead + (30, 50)).astype(np.float32),
                      "s": rng.normal(size=lead + (1000,)).astype(np.float32),
                      "z": rng.normal(size=lead).astype(np.float32)}}
    return {}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


# every codec x transport on three trees; the reference cannot size a
# narrow payload of an empty tree (its pack_bits reshape divides by 0)
ROUND_CASES = [
    (name, transport, narrow, kind)
    for name, transport, narrow in (
        [(name, "leafwise", False) for name in NAMES]
        + [(name, t, False) for name in ("qsgd", "natural")
           for t in ("flat", "packed")]
        + [("qsgd7", t, True) for t in ("flat", "packed")]
        + [("qsgd1", "packed", True)])
    for kind in ("logreg", "multi", "empty")
    if not (narrow and kind == "empty")]


@pytest.mark.parametrize("name,transport,narrow,kind", ROUND_CASES)
def test_round_bits_exact(name, transport, narrow, kind):
    kw = {"qsgd7": {"levels": 7}, "qsgd1": {"levels": 1}}.get(name, {})
    base = name[:4] if name.startswith("qsgd") else name
    tree = _tree(kind, np.random.default_rng(0))
    jp = jcodec.make_plan(jcomp.make_compressor(base, **kw), _jax(tree),
                          transport=transport, narrow=narrow)
    tp = tcodec.make_plan(tcomp.make_compressor(base, **kw),
                          params_from_numpy(tree), transport=transport,
                          narrow=narrow)
    assert tp.round_bits() == jp.round_bits()
    if kind != "empty":     # the spec is the payload the encoder builds
        payload = tp.encode(prng.PRNGKey(1), params_from_numpy(tree))
        assert payload.nbits == tp.round_bits()


@pytest.mark.parametrize("levels", [1, 3, 7])
def test_narrow_wire_round_trip_exact(levels):
    tree = _tree("multi", np.random.default_rng(levels), n=2)
    keys = _keys(2, seed=levels)
    jplan = jcodec.make_plan(jcomp.QSGD(levels=levels), transport="packed",
                             narrow=True)
    jn = jax.vmap(jplan.encode)(keys, _jax(tree))
    jwide = jfb.widen_tree_qsgd(jn)
    tplan = tcodec.make_plan(tcomp.QSGD(levels=levels), transport="packed",
                             narrow=True)
    # narrow the reference's own int8 payload: the repack is exact
    layout = tfb.layout_of(params_from_numpy(tree), 2048, batch_dims=1)
    layout = tfb.layout_of(params_from_numpy(tree),
                           tfb._clamp_bucket(2048, layout.d), batch_dims=1)
    int8 = tcodec.QSGDPayload(torch.from_numpy(np.array(jwide.codes)),
                              torch.from_numpy(np.array(jwide.norms)),
                              levels=levels, layout=layout)
    tn = tfb.narrow_tree_qsgd(int8)
    assert tn.width == jn.width == (2 if levels == 1 else 4)
    np.testing.assert_array_equal(tn.codes.numpy(), np.asarray(jn.codes))
    assert tn.nbits == jn.nbits
    back = tfb.widen_tree_qsgd(tn)
    assert torch.equal(back.codes, int8.codes)
    # the port's own narrow encode widens to its own int8 encode
    own = tplan.encode(np.asarray(keys), params_from_numpy(tree))
    plain = tcodec.make_plan(tcomp.QSGD(levels=levels),
                             transport="packed").encode(
        np.asarray(keys), params_from_numpy(tree))
    assert torch.equal(tfb.widen_tree_qsgd(own).codes, plain.codes)
    for a, b in zip(tree_leaves(tplan.decode(own)),
                    tree_leaves(tfb.unpack_tree(plain))):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(tfb.reduce_payload_mean(own)),
                    tree_leaves(tfb.reduce_payload_mean(plain))):
        assert torch.equal(a, b)


def test_make_plan_refusals_match_reference():
    for kw, what in [
        ({"transport": "leafwise", "narrow": True}, "needs the flat"),
        ({"narrow": True}, "4-bit"),                      # levels 127
    ]:
        with pytest.raises(ValueError, match=what):
            tcodec.make_plan(tcomp.QSGD(), **kw)
    with pytest.raises(ValueError, match="QSGD sub-byte"):
        tcodec.make_plan(tcomp.Natural(), narrow=True)
    with pytest.raises(ValueError, match="flat-engine"):
        tcodec.make_plan(tcomp.TopK(), transport="flat")
    with pytest.raises(ValueError, match="int8"):
        tcodec.make_plan(tcomp.QSGD(levels=300), transport="flat")
    for name in NAMES:
        jp = jcodec.make_plan(jcomp.make_compressor(name))
        tp = tcodec.make_plan(tcomp.make_compressor(name))
        assert tp.transport == jp.transport


@pytest.mark.parametrize("name,kw,transport,narrow", [
    ("qsgd", {"levels": 7, "bucket": 512}, "packed", True),
    ("natural", {}, "flat", False), ("bernoulli", {"q": 0.3}, "leafwise",
                                     False),
    ("randk", {"fraction": 0.2}, "leafwise", False)])
def test_plan_spec_round_trip(name, kw, transport, narrow):
    plan = tcodec.make_plan(tcomp.make_compressor(name, **kw),
                            transport=transport, narrow=narrow)
    spec = tcodec.plan_spec(plan)
    assert spec == jcodec.plan_spec(jcodec.make_plan(
        jcomp.make_compressor(name, **kw), transport=transport,
        narrow=narrow))
    back = tcodec.plan_from_spec(spec)
    assert (back.codec, back.transport, back.bucket, back.narrow) == \
        (plan.codec, plan.transport, plan.bucket, plan.narrow)


def test_decode_payload_every_kind():
    tree = params_from_numpy(_tree("multi", np.random.default_rng(5)))
    k = prng.PRNGKey(3)
    for name in NAMES:
        comp = tcomp.make_compressor(name)
        plan = tcodec.make_plan(comp, transport="leafwise")
        payload = plan.encode(k, tree)
        for a, b in zip(tree_leaves(tcodec.decode_payload(payload, comp)),
                        tree_leaves(plan.decode(payload))):
            assert torch.equal(a, b)
    packed = tcodec.make_plan(tcomp.QSGD(levels=7), transport="packed",
                              narrow=True)
    payload = packed.encode(k, tree)
    for a, b in zip(tree_leaves(tcodec.decode_payload(payload)),
                    tree_leaves(packed.decode(payload))):
        assert torch.equal(a, b)
    dense = tcomp.Identity().encode(k, tree["b"])
    assert torch.equal(tcodec.decode_payload(dense), tree["b"])
    with pytest.raises(ValueError):
        tcodec.decode_payload(plan.encode(k, tree))


# --------------------------------------------------------------------------
# the leafwise uplink and the runs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_compressed_average_leafwise(name):
    """Client i uses split(k_clients, n)[i], split again over the leaves:
    the whole aggregation equals the reference's (QSGD within the layered
    rule's one downlink level)."""
    tree = _tree("multi", np.random.default_rng(11), n=4)
    key = jax.random.PRNGKey(12)
    jp = jcodec.make_plan(jcomp.make_compressor(name), transport="leafwise")
    tp = tcodec.make_plan(tcomp.make_compressor(name), transport="leafwise")
    want = jax.jit(lambda k, t: jagg.compressed_average(k, t, jp, jp))(
        key, _jax(tree))
    got = tagg.compressed_average(np.asarray(key), params_from_numpy(tree),
                                  tp, tp)
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        b = np.asarray(b)
        if name == "qsgd":
            step = 2 * np.sqrt(np.sum(b.astype(np.float64) ** 2)) / 127
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=step)
        else:
            np.testing.assert_array_equal(a.numpy(), b)


def test_leafwise_guard_excludes_poisoned_clients():
    tree = _tree("multi", np.random.default_rng(13), n=4)
    tree["a"]["k"][2, 0, 0] = np.nan
    key = jax.random.PRNGKey(14)
    jp = jcodec.make_plan(jcomp.Natural(), transport="leafwise")
    tp = tcodec.make_plan(tcomp.Natural(), transport="leafwise")
    want = jax.jit(lambda k, t: jagg.compressed_average(k, t, jp, jp))(
        key, _jax(tree))
    got = tagg.compressed_average(np.asarray(key), params_from_numpy(tree),
                                  tp, tp)
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert np.all(np.isfinite(a.numpy()))
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_all_finite_with_no_clients_is_true_on_the_input_device():
    """The reference's ``jnp.bool_(True)`` for n = 0; torch.min of an
    empty tensor would raise."""
    fin = torch.ones((0,), device="meta")
    out = tagg.all_finite(fin)
    assert out.dtype == torch.bool and out.device.type == "meta"
    assert bool(tagg.all_finite(torch.ones((0,))))
    assert not bool(tagg.all_finite(torch.tensor([1.0, 0.0])))


@pytest.mark.parametrize("name", ["identity", "natural"])
def test_compressed_average_of_no_clients_is_nan(name):
    """n = 0: the guard selects the plain mean, which is 0 * inf = NaN on
    both sides, and the downlink passes NaN through."""
    jp = jcodec.make_plan(jcomp.make_compressor(name), transport="leafwise")
    tp = tcodec.make_plan(tcomp.make_compressor(name), transport="leafwise")
    key = jax.random.PRNGKey(0)
    want = jax.jit(lambda k, t: jagg.compressed_average(k, t, jp, jp))(
        key, {"w": jnp.zeros((0, 5))})
    got = tagg.compressed_average(np.asarray(key), {"w": torch.zeros(0, 5)},
                                  tp, tp)
    assert got["w"].shape == (5,)
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))


def test_ravel_of_an_empty_tree_on_the_named_device():
    layout = tfb.layout_of({}, 128)
    assert tfb.ravel(layout, {}).shape == (0,)
    assert tfb.ravel(layout, {}, device="meta").device.type == "meta"


def _logreg():
    data = make_logreg_data(n_clients=5, heterogeneity=1.5, seed=0)
    X, Y = jnp.asarray(data.features), jnp.asarray(data.labels)
    TX, TY = torch.from_numpy(data.features), torch.from_numpy(data.labels)

    def jgrad(p, b):
        loss, g = jlogreg(p["w"], b[0], b[1], 0.01)
        return loss, {"w": g}

    def tgrad(p, b):
        loss, g = logreg_loss_and_grad(p["w"], b[0], b[1], 0.01)
        return loss, {"w": g}

    return (X, Y), (TX, TY), jgrad, tgrad


@pytest.mark.parametrize("name", NAMES)
def test_run_l2gd_logreg_leafwise(name):
    """The quickstart's configuration with every codec pinned leafwise
    both ways: 5 clients, d = 124, PRNGKey(0), 300 steps."""
    (X, Y), (TX, TY), jgrad, tgrad = _logreg()
    jc, tc = jcomp.make_compressor(name), tcomp.make_compressor(name)
    one_j, one_t = {"w": jnp.zeros(124)}, {"w": torch.zeros(124)}
    jplans = tuple(jcodec.make_plan(jc, one_j, transport="leafwise")
                   for _ in range(2))
    tplans = tuple(tcodec.make_plan(tc, one_t, transport="leafwise")
                   for _ in range(2))
    jr = jrun(jax.random.PRNGKey(0), {"w": jnp.zeros((5, 124))}, jgrad,
              JHyper(eta=0.5, lam=1.0, p=0.3, n=5), lambda k: (X, Y), 300,
              plan=jplans)
    tr = run_l2gd(prng.PRNGKey(0), {"w": torch.zeros(5, 124)}, tgrad,
                  L2GDHyper(eta=0.5, lam=1.0, p=0.3, n=5),
                  lambda k: (TX, TY), 300, plan=tplans, device="cpu")
    np.testing.assert_array_equal(tr.xis, np.asarray(jr.xis))
    assert (tr.n_local, tr.n_agg_comm, tr.n_agg_cached) == \
        (jr.n_local, jr.n_agg_comm, jr.n_agg_cached)
    assert tr.ledger.history == jr.ledger.history
    assert tr.ledger.uplink_bits_per_client == jr.ledger.uplink_bits_per_client
    assert tr.ledger.downlink_bits_per_client == \
        jr.ledger.downlink_bits_per_client
    w = np.asarray(jr.state.params["w"])
    atol = RUN_ULPS * np.spacing(np.float32(np.abs(w).max()))
    if name == "qsgd":   # a bucket norm an ulp apart moves a rare code
        atol = np.sqrt(np.sum(np.mean(w, 0) ** 2)) / 127
    np.testing.assert_allclose(tr.state.params["w"].numpy(), w, rtol=0,
                               atol=atol)
    np.testing.assert_allclose([v for _, v in tr.losses],
                               [v for _, v in jr.losses], rtol=1e-5)
