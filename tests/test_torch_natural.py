"""Parity of the port's natural codec with the JAX reference: the plain
PyTorch versions of the three natural kernels (which the CUDA kernels are
held to on the card), the bit helpers, the flat-buffer engine's natural
branches, the server reduce and compressed L2GD with natural compression.

Natural compression is integer work on float32 bit patterns, so nearly
every check here is bit for bit.  The one rule the reference does not
agree on with itself is the subnormal one: the port rounds a subnormal
like any finite value and passes only exponent-255 values (Inf, NaN)
through unchanged, which equals the Pallas kernel in interpret mode and
``natural_pack_ref``; the jitted ``natural_fused_ref`` compiles ``x ==
0.0`` with denormals-are-zero on XLA:CPU and passes subnormals through,
so it is compared only on inputs without subnormals.

Tolerances: the reduce and the mean are bit-exact against the jitted
reduce of the reference's CPU path (every decoded value is a power of
two, so each weighted product is exact and an FMA changes nothing; the
accumulator starts as client 0's term, as XLA compiles ``0 + y``).
End-to-end runs hold xi traces, ledgers and branch counts exact, and
params within RUN_ULPS units in the last place of the largest parameter
and losses within 1e-5 relative: the reference contracts its updates
into FMAs (tests/test_torch_l2gd.py), which moves a value by an ulp and,
rarely, the rounding of a compressed value with it.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_threads import torch_one_thread  # noqa: F401
from conftest import quad_batch, quad_grad_fn
from repro.core import L2GDHyper as JHyper
from repro.core import codec as jcodec
from repro.core import compressors as jcomp
from repro.core import flatbuf as jfb
from repro.data import logreg_loss_and_grad as jlogreg
from repro.data import make_logreg_data
from repro.fl import run_l2gd as jrun
from repro.kernels.natural.kernel import natural_fused_pallas
from repro.kernels.natural.ops import natural_reduce as jax_reduce_jit
from repro.kernels.natural.ops import natural_reduce_pallas
from repro.kernels.natural.ref import natural_fused_ref as jax_fused_ref
from repro.kernels.natural.ref import natural_pack_ref as jax_pack_ref
from repro.kernels.natural.ref import natural_reduce_ref as jax_reduce_ref
from repro_torch.convert import params_from_numpy
from repro_torch.core import L2GDHyper, make_compressor, make_plan, prng
from repro_torch.core import codec as tcodec
from repro_torch.core import compressors as tcomp
from repro_torch.core import flatbuf as tfb
from repro_torch.core.tree import tree_leaves
from repro_torch.data import logreg_loss_and_grad
from repro_torch.fl import run_l2gd
from repro_torch.kernels import bits as tbits
from repro_torch.kernels.dispatch import LAUNCHES
from repro_torch.kernels.natural.kernel import natural_fused, natural_pack
from repro_torch.kernels.natural.ops import natural_compress, natural_reduce
from repro_torch.kernels.natural.ref import (natural_fused_ref,
                                             natural_pack_ref)

U32 = np.uint32
SEEDS = np.array([0x12345678, 0x9ABCDEF0], U32)


def _bits(a):
    return np.asarray(a, np.float32).view(U32)


def _buffer(nb=6, seed=0, special=True):
    """(nb, 128) float32 with a zero bucket and, if ``special``, ±0,
    subnormals, ±Inf, NaN and exponent-254 values that may carry."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(nb, 128)).astype(np.float32)
    x[1] = 0.0
    if special:
        flat = x.reshape(-1).view(U32)
        flat[:8] = _bits([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-42,
                          3.4e38])
        flat[8:16] = 0x7F7FFFFF           # largest finite: carry -> +Inf
        flat[16:24] = 0xFF7FFFFF          # ... -> -Inf
        flat[24:56] = rng.integers(1, 0x7FFFFF, 32).astype(U32)  # subnormal
        flat[56:64] |= 0x80000000
    return x


def _no_subnormals(x):
    b = x.view(U32)
    return not np.any(((b & 0x7F800000) == 0) & ((b & 0x7FFFFF) != 0))


# --------------------------------------------------------------------------
# bit helpers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("width", [1, 2, 4])
def test_pack_unpack_bits_exact(width):
    rng = np.random.default_rng(width)
    fields = rng.integers(0, 1 << width, size=(3, 64)).astype(np.uint32)
    want = np.asarray(jcodec.pack_bits(jnp.asarray(fields), width))
    got = tbits.pack_bits(torch.from_numpy(fields.astype(np.uint8)), width)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tbits.unpack_bits(got, width).numpy(),
        np.asarray(jcodec.unpack_bits(jnp.asarray(want), width)))


def test_pack_bits_is_little_endian_within_the_byte():
    """Bit j of byte k is field 8k + j at width 1."""
    fields = torch.zeros(16, dtype=torch.uint8)
    fields[3] = fields[9] = 1
    np.testing.assert_array_equal(tbits.pack_bits(fields, 1).numpy(),
                                  [0b00001000, 0b00000010])
    with pytest.raises(ValueError):
        tbits.pack_bits(fields, 3)


def test_natural_split_merge_exact():
    x = _buffer(special=False)
    x.reshape(-1)[:4] = [-0.0, -1.0, -2.0 ** -126, -2.0 ** 127]
    y = np.array(jax_fused_ref(jnp.asarray(x), jnp.asarray(SEEDS)))
    je, js = jcodec.natural_split(jnp.asarray(y))
    te, ts = tbits.natural_split(torch.from_numpy(y))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    merged = tbits.natural_merge(te, ts).numpy()
    np.testing.assert_array_equal(_bits(merged), _bits(y))
    np.testing.assert_array_equal(
        _bits(merged), _bits(jcodec.natural_merge(je, js)))


def test_sign_shift_is_the_top_bit():
    """(sign << 31) in int32 is the bit pattern 0x80000000: -0.0."""
    y = tbits.natural_merge(torch.zeros(1, dtype=torch.uint8),
                            torch.ones(1, dtype=torch.uint8))
    assert _bits(y.numpy())[0] == 0x80000000
    assert tbits.float_bits(y).item() == 0x80000000
    assert _bits(tbits.bits_float(tbits.float_bits(y)).numpy())[0] \
        == 0x80000000


# --------------------------------------------------------------------------
# the three kernels' plain versions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("special", [False, True])
def test_fused_equals_pallas_interpret(special):
    x = _buffer(special=special)
    want = natural_fused_pallas(jnp.asarray(x), jnp.asarray(SEEDS),
                                interpret=True, hw_rng=False)
    got = natural_fused(torch.from_numpy(x), SEEDS)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_fused_equals_jitted_ref_without_subnormals():
    x = _buffer(special=True)
    x.reshape(-1)[24:56] = 1.5         # the subnormal block, made normal
    x.reshape(-1)[5:7] = 0.25
    assert _no_subnormals(x)
    want = jax_fused_ref(jnp.asarray(x), jnp.asarray(SEEDS))
    got = natural_fused(torch.from_numpy(x), SEEDS)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_subnormal_rule_pinned():
    """Subnormals round in the bits domain (to ±0 or ±2^-126), where the
    jitted jnp oracle passes them through; Inf and NaN keep their bits;
    the exponent-254 carry becomes ±Inf."""
    x = _buffer(special=True)
    got = _bits(natural_fused(torch.from_numpy(x), SEEDS).numpy()) \
        .reshape(-1)
    sub = x.reshape(-1).view(U32)[24:56]
    assert set(got[24:56] & 0x7FFFFFFF) <= {0, 0x00800000}
    np.testing.assert_array_equal(got[24:56] & 0x80000000,
                                  sub & 0x80000000)
    jitted = _bits(jax_fused_ref(jnp.asarray(x), jnp.asarray(SEEDS))) \
        .reshape(-1)
    np.testing.assert_array_equal(jitted[24:56], sub)     # the reference's DAZ
    np.testing.assert_array_equal(got[:5], x.reshape(-1).view(U32)[:5])
    assert set(got[8:16]) <= {0x7F000000, 0x7F800000}
    assert set(got[16:24]) <= {0xFF000000, 0xFF800000}


@pytest.mark.parametrize("special", [False, True])
def test_pack_equals_reference_and_merges_to_fused(special):
    x = _buffer(special=special)
    je, js = jax_pack_ref(jnp.asarray(x), jnp.asarray(SEEDS))
    te, ts = natural_pack(torch.from_numpy(x), SEEDS)
    assert te.dtype == ts.dtype == torch.uint8 and ts.shape == (6, 16)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    fused = natural_fused(torch.from_numpy(x), SEEDS).numpy()
    finite = (x.view(U32) & 0x7F800000) != 0x7F800000
    merged = tbits.natural_merge(te, tbits.unpack_bits(ts, 1)).numpy()
    np.testing.assert_array_equal(_bits(merged)[finite], _bits(fused)[finite])


@pytest.mark.parametrize("n", [1, 3, 8])
def test_pack_batched_restarts_the_index_per_client(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 3, 128)).astype(np.float32)
    seeds = rng.integers(0, 2 ** 32, size=(n, 2), dtype=np.uint64) \
        .astype(U32)
    te, ts = natural_pack(torch.from_numpy(x), seeds)
    assert te.shape == (n, 3, 128) and ts.shape == (n, 3, 16)
    for i in range(n):
        je, js = jax_pack_ref(jnp.asarray(x[i]), jnp.asarray(seeds[i]))
        np.testing.assert_array_equal(te[i].numpy(), np.asarray(je))
        np.testing.assert_array_equal(ts[i].numpy(), np.asarray(js))


def test_window_near_the_index_wrap():
    """A window with row_offset just below 2^32 / 128 continues the
    whole buffer's stream across the uint32 wrap of the flat index."""
    row_offset = 2 ** 32 // 128 - 2          # rows straddle index 2^32
    x = _buffer(nb=4, special=False)
    seeds = jnp.asarray(SEEDS)
    from repro.kernels.natural.ref import natural_compress_ref
    from repro.kernels.rng import counter_bits, counter_uniform_2d
    noise = counter_uniform_2d(seeds, x.shape, row_offset=row_offset)
    want = natural_compress_ref(jnp.asarray(x), noise)
    got = natural_fused_ref(torch.from_numpy(x), SEEDS,
                            row_offset=row_offset)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # pack: the integer compare against the same counter bits
    r = jnp.arange(4, dtype=jnp.uint32)[:, None] + jnp.uint32(row_offset)
    idx = r * jnp.uint32(128) + jnp.arange(128, dtype=jnp.uint32)[None]
    rbits = np.asarray(counter_bits(idx, seeds[0], seeds[1])).astype(np.int64)
    b = x.view(U32).astype(np.int64)
    up = ((rbits >> 8) < ((b & 0x7FFFFF) << 1)).astype(np.int64)
    out = (b & 0xFF800000) + (up << 23)
    te, _ = natural_pack_ref(torch.from_numpy(x), SEEDS,
                             row_offset=row_offset)
    np.testing.assert_array_equal(te.numpy(), (out >> 23) & 0xFF)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n", [1, 3, 8])
def test_reduce_equals_reference_routes(n, weighted):
    """Bit for bit against the jitted reduce that the reference's CPU
    path runs; against the interpret-mode Pallas kernel and the eager
    oracle up to the sign of a zero sum: XLA simplifies the jitted
    ``0 + y`` to ``y`` (a -0.0 stays), the eager add gives +0.0, and the
    interpret-mode kernel does either, depending on n."""
    rng = np.random.default_rng(10 + n)
    exps = rng.integers(0, 256, size=(n, 5, 128)).astype(np.uint8)
    exps[:, 0, :4] = 0                       # ±0
    signs = rng.integers(0, 256, size=(n, 5, 16)).astype(np.uint8)
    signs[:, 0, 0] = 0x0F                    # all clients -0.0: a -0 sum
    w = rng.uniform(0, 2, size=n).astype(np.float32) if weighted else None
    jw = None if w is None else jnp.asarray(w)
    je, js = jnp.asarray(exps), jnp.asarray(signs)
    got = natural_reduce(torch.from_numpy(exps), torch.from_numpy(signs),
                         None if w is None else torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(_bits(got),
                                  _bits(jax_reduce_jit(je, js, jw)))
    assert np.all(_bits(got)[0, :4] == 0x80000000)
    for want in (natural_reduce_pallas(je, js, jw, interpret=True),
                 jax_reduce_ref(je, js, jw)):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_wrappers_check_operands_and_count_only_launches():
    before = dict(LAUNCHES)
    x = torch.zeros(2, 128)
    with pytest.raises(ValueError):
        natural_fused(x.double(), SEEDS)
    with pytest.raises(ValueError):
        natural_fused(torch.zeros(2, 100), SEEDS)        # b % 8
    with pytest.raises(ValueError):
        natural_pack(torch.zeros(3, 2, 128), SEEDS)      # seeds (3, 2)
    with pytest.raises(ValueError):
        natural_reduce(torch.zeros(2, 1, 128, dtype=torch.uint8),
                       torch.zeros(2, 1, 8, dtype=torch.uint8))
    natural_fused(x, SEEDS)
    natural_pack(x, SEEDS)
    natural_reduce(torch.zeros(2, 1, 128, dtype=torch.uint8),
                   torch.zeros(2, 1, 16, dtype=torch.uint8))
    assert dict(LAUNCHES) == before      # the CPU path launches nothing


def test_natural_compress_matches_reference():
    from repro.kernels.natural.ops import natural_compress as jcompress
    x = np.random.default_rng(3).normal(size=(7, 30)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = jcompress(key, jnp.asarray(x))
    got = natural_compress(np.asarray(key), torch.from_numpy(x))
    assert got.shape == (7, 30)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


# --------------------------------------------------------------------------
# flat engine and server reduce
# --------------------------------------------------------------------------

def _tree(kind, rng, n=None):
    lead = () if n is None else (n,)
    if kind == "logreg":
        return {"w": rng.normal(size=lead + (124,)).astype(np.float32)}
    return {"b": rng.normal(size=lead + (7,)).astype(np.float32),
            "a": {"k": rng.normal(size=lead + (30, 50)).astype(np.float32),
                  "s": rng.normal(size=lead + (1000,)).astype(np.float32)}}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_tree_equal(got, want):
    gl, wl = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


@pytest.mark.parametrize("kind", ["logreg", "multi"])
def test_pack_tree_unpack_tree_and_flat_apply_exact(kind):
    tree = _tree(kind, np.random.default_rng(1))
    key = jax.random.PRNGKey(2)
    words = np.asarray(key)
    jpay, jl = jfb.pack_tree_natural(key, _jax(tree))
    tpay, tl = tfb.pack_tree_natural(words, params_from_numpy(tree))
    assert (tl.d, tl.bucket, tl.n_buckets) == (jl.d, jl.bucket, jl.n_buckets)
    np.testing.assert_array_equal(tpay.exps.numpy(), np.asarray(jpay.exps))
    np.testing.assert_array_equal(tpay.signs.numpy(), np.asarray(jpay.signs))
    assert tpay.nbits == jpay.nbits
    _assert_tree_equal(tfb.unpack_tree(tpay), jfb.unpack_tree(jpay))
    comp = tcomp.Natural()
    flat = tfb.flat_tree_apply(comp, words, params_from_numpy(tree))
    _assert_tree_equal(flat, jfb.flat_tree_apply(jcomp.Natural(), key,
                                                 _jax(tree)))
    _assert_tree_equal(flat, jfb.unpack_tree(jpay))   # flat == packed
    packed = make_plan(comp, transport="packed").apply(
        words, params_from_numpy(tree))
    _assert_tree_equal(packed, jfb.unpack_tree(jpay))


def test_stacked_pack_tree_is_vmap_of_pack_tree():
    tree = _tree("multi", np.random.default_rng(4), n=3)
    keys = jax.random.split(jax.random.PRNGKey(6), 3)
    plan = jcodec.make_plan(jcomp.Natural(), transport="packed")
    jpay = jax.vmap(plan.encode)(keys, _jax(tree))
    tpay = make_plan(tcomp.Natural(), transport="packed").encode(
        np.asarray(keys), params_from_numpy(tree))
    np.testing.assert_array_equal(tpay.exps.numpy(), np.asarray(jpay.exps))
    np.testing.assert_array_equal(tpay.signs.numpy(), np.asarray(jpay.signs))
    _assert_tree_equal(tfb.unpack_tree(tpay), jax.vmap(jfb.unpack_tree)(jpay))


@pytest.mark.parametrize("poison", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [1, 3, 8])
def test_reduce_payload_mean_exact(n, masked, poison):
    """The server's one-pass mean equals the reference bit for bit, with
    a participation mask and with a client whose message carries code 255
    (excluded from numerator and denominator)."""
    rng = np.random.default_rng(20 + n)
    tree = _tree("multi", rng, n=n)
    keys = jax.random.split(jax.random.PRNGKey(9), n)
    plan = jcodec.make_plan(jcomp.Natural(), transport="packed")
    jpay = jax.vmap(plan.encode)(keys, _jax(tree))
    tpay = make_plan(tcomp.Natural(), transport="packed").encode(
        np.asarray(keys), params_from_numpy(tree))
    if poison and n > 1:
        exps = np.array(jpay.exps)
        exps[1, 2, 5] = 255
        jpay = jpay.__class__(jnp.asarray(exps), jpay.signs,
                              layout=jpay.layout)
        tpay = tcodec.NaturalPayload(torch.from_numpy(exps), tpay.signs,
                                     layout=tpay.layout)
    mask = (rng.uniform(size=n) < 0.7).astype(np.float32) if masked else None
    if mask is not None:
        mask[0] = 1.0
    np.testing.assert_array_equal(tfb.payload_finite_mask(tpay).numpy(),
                                  np.asarray(jfb.payload_finite_mask(jpay)))
    assert tfb.supports_fused_reduce(tpay)
    got = tfb.reduce_payload_mean(
        tpay, None if mask is None else torch.from_numpy(mask))
    want = jfb.reduce_payload_mean(
        jpay, None if mask is None else jnp.asarray(mask))
    _assert_tree_equal(got, want)


def test_sanitize_zeroes_exponents_of_poisoned_clients():
    exps = torch.full((2, 1, 128), 130, dtype=torch.uint8)
    exps[1, 0, 0] = 255
    pay = tcodec.NaturalPayload(exps, torch.zeros(2, 1, 16, dtype=torch.uint8),
                                layout=tfb.layout_of({"w": torch.zeros(128)},
                                                     128))
    fin = tfb.payload_finite_mask(pay)
    np.testing.assert_array_equal(fin.numpy(), [1.0, 0.0])
    clean = tfb.sanitize_payload(pay, fin)
    assert torch.equal(clean.exps[0], exps[0])
    assert int(clean.exps[1].max()) == 0


@pytest.mark.parametrize("transport", [None, "flat", "packed"])
def test_round_bits_natural_exact(transport):
    for tree in (_tree("logreg", np.random.default_rng(0)),
                 _tree("multi", np.random.default_rng(0)), {}):
        jp = jcodec.make_plan(jcomp.Natural(), _jax(tree),
                              transport=transport)
        tp = tcodec.make_plan(tcomp.Natural(), params_from_numpy(tree),
                              transport=transport)
        assert tp.transport == jp.transport
        assert tp.round_bits() == jp.round_bits()
    plan = tcodec.make_plan(tcomp.Natural(), {"w": torch.zeros(124)})
    assert plan.round_bits() == 9 * 128


# --------------------------------------------------------------------------
# compressed L2GD with natural compression
# --------------------------------------------------------------------------

def _quad_torch(params, batch):
    g = params["w"] - batch
    return 0.5 * torch.sum(g ** 2, dim=1), {"w": g}


def _check_run(jr, tr, atol_params, rtol_loss):
    np.testing.assert_array_equal(tr.xis, np.asarray(jr.xis))
    assert (tr.n_local, tr.n_agg_comm, tr.n_agg_cached) == \
        (jr.n_local, jr.n_agg_comm, jr.n_agg_cached)
    assert tr.ledger.rounds == jr.ledger.rounds
    assert tr.ledger.uplink_bits_per_client == jr.ledger.uplink_bits_per_client
    assert tr.ledger.downlink_bits_per_client == \
        jr.ledger.downlink_bits_per_client
    assert tr.ledger.history == jr.ledger.history
    jl = np.array([v for _, v in jr.losses])
    tl = np.array([v for _, v in tr.losses])
    np.testing.assert_allclose(tl, jl, rtol=rtol_loss)
    np.testing.assert_allclose(tr.state.params["w"].numpy(),
                               np.asarray(jr.state.params["w"]), rtol=0,
                               atol=atol_params)


RUN_ULPS = 16


def _run_atol(w):
    return RUN_ULPS * np.spacing(np.float32(np.abs(w).max()))


@pytest.mark.parametrize("transport,mode", [(None, "scan"), (None, "host"),
                                            ("packed", "scan")])
def test_run_l2gd_logreg_natural(transport, mode):
    """The quickstart's natural line: 5 clients, d = 124, eta 0.5,
    lambda 1, p 0.3, PRNGKey(0), 500 steps (auto = flat uplink and
    downlink; packed pins the uplink)."""
    data = make_logreg_data(n_clients=5, heterogeneity=1.5, seed=0)
    X, Y = jnp.asarray(data.features), jnp.asarray(data.labels)
    TX, TY = torch.from_numpy(data.features), torch.from_numpy(data.labels)

    def jgrad(p, b):
        loss, g = jlogreg(p["w"], b[0], b[1], 0.01)
        return loss, {"w": g}

    def tgrad(p, b):
        loss, g = logreg_loss_and_grad(p["w"], b[0], b[1], 0.01)
        return loss, {"w": g}

    jc, tc = jcomp.make_compressor("natural"), make_compressor("natural")
    jplan = None if transport is None else jcodec.make_plan(
        jc, {"w": jnp.zeros(124)}, transport=transport)
    tplan = None if transport is None else make_plan(
        tc, {"w": torch.zeros(124)}, transport=transport)
    jr = jrun(jax.random.PRNGKey(0), {"w": jnp.zeros((5, 124))}, jgrad,
              JHyper(eta=0.5, lam=1.0, p=0.3, n=5), lambda k: (X, Y), 500,
              client_comp=jc, master_comp=jc, plan=jplan, mode=mode)
    tr = run_l2gd(prng.PRNGKey(0), {"w": torch.zeros(5, 124)}, tgrad,
                  L2GDHyper(eta=0.5, lam=1.0, p=0.3, n=5),
                  lambda k: (TX, TY), 500, client_comp=tc, master_comp=tc,
                  plan=tplan, mode=mode, device="cpu")
    _check_run(jr, tr, _run_atol(jr.state.params["w"]), 1e-5)
    assert tr.ledger.uplink_bits_per_client == 9 * 128 * tr.ledger.rounds
    assert tr.losses[-1][1] < tr.losses[0][1]


@pytest.mark.parametrize("forced,mode", [(False, "scan"), (True, "host")])
def test_run_l2gd_quadratic_natural(forced, mode):
    n, d, steps = 4, 12, 60
    base = np.array(quad_batch(n, d))
    jc, tc = jcomp.make_compressor("natural"), make_compressor("natural")
    xi = (np.arange(steps) % 3 != 0).astype(np.int32) if forced else None
    jb = [jnp.asarray(base * (1 + 0.01 * k)) for k in range(steps)]
    tb = [torch.from_numpy((base * (1 + 0.01 * k)).astype(np.float32))
          for k in range(steps)]
    jr = jrun(jax.random.PRNGKey(3), {"w": jnp.zeros((n, d))}, quad_grad_fn,
              JHyper(eta=0.2, lam=0.5, p=0.4, n=n), lambda k: jb[k], steps,
              client_comp=jc, master_comp=jc, xi_trace=xi, mode=mode,
              local_steps=2)
    tr = run_l2gd(prng.PRNGKey(3), {"w": torch.zeros(n, d)}, _quad_torch,
                  L2GDHyper(eta=0.2, lam=0.5, p=0.4, n=n), lambda k: tb[k],
                  steps, client_comp=tc, master_comp=tc, xi_trace=xi,
                  mode=mode, local_steps=2, device="cpu")
    _check_run(jr, tr, _run_atol(jr.state.params["w"]), 1e-5)
