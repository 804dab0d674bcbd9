"""Parity of the port's explicit-noise kernels — ``qsgd_dequantized`` and
``natural_compress_2d``, whose CUDA kernels the leafwise QSGD and natural
codecs run — with the JAX reference: their plain PyTorch versions (the
CPU path, and what the CUDA kernels are held to on the card) against the
reference's Pallas kernels in interpret mode and its jitted jnp oracles,
on the same seeded inputs and noise; the chunked threefry draws that feed
them; and the routed leafwise codecs against the reference's.

Bounds, as in tests/test_torch_qsgd.py (the layered rule): a bucket norm
is a float sum whose order differs between XLA:CPU and ``torch.sum``, so
norms agree within NORM_ULPS, outputs are bit-exact given the same norms
and within one level (norm / levels) otherwise.  Natural compression is
bit-exact everywhere against the Pallas kernel and the jitted oracle,
subnormals included; the oracle evaluated eagerly passes subnormals
through (XLA:CPU's denormals-are-zero compare), which a test pins.

The sign of a zero: where x < 0 rounds to level 0, the TPU kernel (and
the port's) give -0.0; the reference's leafwise QSGD, which goes through
integer codes, gives +0.0 there.  The values are equal; the routed
codec is held to the reference's codec by value.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_threads import torch_one_thread  # noqa: F401
from repro.core import compressors as jcomp
from repro.kernels.natural.kernel import natural_compress_2d as jnatural_2d
from repro.kernels.natural.ref import natural_compress_ref as jnatural_ref
from repro.kernels.qsgd.kernel import qsgd_dequantized as jqsgd_dequantized
from repro.kernels.qsgd.ref import qsgd_dequantized_ref as jqsgd_ref
from repro_torch.core import compressors as tcomp
from repro_torch.core import prng
from repro_torch.kernels.dispatch import LAUNCHES
from repro_torch.kernels.natural.kernel import natural_compress_2d
from repro_torch.kernels.natural.ref import natural_compress_2d_ref
from repro_torch.kernels.qsgd.kernel import qsgd_dequantized
from repro_torch.kernels.qsgd.ref import (dequantize_with_noise,
                                          qsgd_dequantized_ref)

U32 = np.uint32
NORM_ULPS = 4
LEVELS = [1, 7, 127, 255]
SHAPES = {"zero-bucket": (4, 128), "bucket": (3, 2048), "lanes": (2, 384),
          "odd": (3, 100)}


def _buffer(kind, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=SHAPES[kind]) * 3.0).astype(np.float32)
    x[1] = 0.0 if kind == "zero-bucket" else x[1]
    u = rng.random(SHAPES[kind], dtype=np.float32)
    return x, u


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(U32)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.max(np.abs(a - b) / np.spacing(np.maximum(np.abs(a), 1e-30)))


def _jnorms(x):
    """The reference's bucket norms, as its kernel and oracle sum them."""
    xf = jnp.asarray(x).astype(jnp.float32)
    return np.array(jax.jit(lambda v: jnp.sqrt(jnp.sum(
        v * v, axis=1, keepdims=True)))(xf))


# --------------------------------------------------------------------------
# qsgd_dequantized: the plain version against the Pallas kernel and oracle
# --------------------------------------------------------------------------

@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("kind", list(SHAPES))
def test_qsgd_dequantized_layered_against_pallas_and_oracle(kind, levels):
    x, u = _buffer(kind, seed=levels)
    pallas = np.asarray(jqsgd_dequantized(jnp.asarray(x), jnp.asarray(u),
                                          levels=levels, interpret=True))
    oracle = np.asarray(jax.jit(jqsgd_ref, static_argnames="levels")(
        jnp.asarray(x), jnp.asarray(u), levels=levels))
    np.testing.assert_array_equal(_bits(pallas), _bits(oracle))
    jn = _jnorms(x)
    # given the reference's norms: bit-exact (zero signs included)
    given = qsgd_dequantized_ref(torch.from_numpy(x), torch.from_numpy(u),
                                 levels, norms=torch.from_numpy(jn))
    np.testing.assert_array_equal(_bits(given.numpy()), _bits(pallas))
    # its own norms: within NORM_ULPS; equal outputs where norms agree,
    # within one level elsewhere
    norms = torch.empty(x.shape[0], 1)
    own = qsgd_dequantized(torch.from_numpy(x), torch.from_numpy(u),
                           levels=levels, norms_out=norms).numpy()
    assert _ulps(norms.numpy(), jn) <= NORM_ULPS
    same = (norms.numpy() == jn)[:, 0]
    np.testing.assert_array_equal(own[same], pallas[same])
    assert np.all(np.abs(own - pallas) <= jn / levels * 1.000001)
    if kind == "zero-bucket":
        assert float(norms[1]) == 0.0 and not np.any(own[1])
        assert not np.any(_bits(own[1]))          # +0.0, as the kernel's


@pytest.mark.parametrize("levels", [7, 127])
def test_qsgd_dequantized_bf16_against_pallas(levels):
    x, u = _buffer("lanes", seed=11)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    pallas = jqsgd_dequantized(xb, jnp.asarray(u), levels=levels,
                               interpret=True)
    assert pallas.dtype == jnp.bfloat16
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))) \
        .to(torch.bfloat16)
    got = qsgd_dequantized_ref(xt, torch.from_numpy(u), levels,
                               norms=torch.from_numpy(_jnorms(xb)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(),
        np.asarray(pallas).view(np.int16))


def test_zero_sign_pin():
    """x < 0 rounding to level 0 gives -0.0 in the TPU kernel and the
    port's kernel; the reference's leafwise QSGD (integer codes) gives
    +0.0 there.  Equal as values."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 2048)).astype(np.float32)
    u = rng.random(x.shape, dtype=np.float32)
    pallas = np.asarray(jqsgd_dequantized(jnp.asarray(x), jnp.asarray(u),
                                          levels=1, interpret=True))
    got = qsgd_dequantized(torch.from_numpy(x), torch.from_numpy(u),
                           levels=1).numpy()
    neg_zero = (_bits(pallas) == 0x80000000)
    assert neg_zero.sum() > 1000 and np.all(x[neg_zero] < 0)
    np.testing.assert_array_equal(_bits(got)[neg_zero], 0x80000000)
    # the codec's route: codes are integers, so its zeros are +0.0
    jc = jcomp.QSGD(levels=1, bucket=2048)
    key = jax.random.PRNGKey(5)
    codec = np.asarray(jax.jit(jc.apply)(key, jnp.asarray(x.reshape(-1))))
    routed = tcomp.QSGD(levels=1, bucket=2048).apply(
        np.asarray(key), torch.from_numpy(x.reshape(-1))).numpy()
    zeros = codec == 0.0
    assert np.all(_bits(codec)[zeros] == 0)
    assert np.any(_bits(routed)[zeros] == 0x80000000)
    np.testing.assert_array_equal(routed[zeros], codec[zeros])


# --------------------------------------------------------------------------
# natural_compress_2d: bit-exact against the Pallas kernel
# --------------------------------------------------------------------------

def _special(n=4, b=128, seed=0):
    """±0, subnormals, ±Inf, NaN, the largest finite values (whose bump
    carries to ±Inf) and 32 random mantissas of exponent 0 (subnormals)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, b)).astype(np.float32)
    bits = x.reshape(-1).view(U32)
    bits[:7] = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-42],
                        np.float32).view(U32)
    bits[8:16] = 0x7F7FFFFF
    bits[16:24] = 0xFF7FFFFF
    bits[24:56] = rng.integers(1, 0x7FFFFF, size=32).astype(U32)
    bits[40:56] |= 0x80000000
    u = rng.random(x.shape, dtype=np.float32)
    u.reshape(-1)[8:24] = 0.0          # the carries bump for sure
    return x, u


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e4])
@pytest.mark.parametrize("shape", [(1, 128), (16, 128), (64, 384), (5, 100)])
def test_natural_2d_equals_pallas_and_oracle(shape, scale):
    rng = np.random.default_rng(int(scale * 10) + shape[0])
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    u = rng.random(shape, dtype=np.float32)
    pallas = np.asarray(jnatural_2d(jnp.asarray(x), jnp.asarray(u),
                                    interpret=True))
    oracle = np.asarray(jax.jit(jnatural_ref)(jnp.asarray(x),
                                              jnp.asarray(u)))
    got = natural_compress_2d(torch.from_numpy(x), torch.from_numpy(u))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(pallas))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(oracle))


def test_natural_2d_special_values_equal_pallas():
    """±0, subnormals, ±Inf, NaN and the exponent-254 carry, bit for bit
    against the Pallas kernel in interpret mode."""
    x, u = _special()
    pallas = np.asarray(jnatural_2d(jnp.asarray(x), jnp.asarray(u),
                                    interpret=True))
    got = _bits(natural_compress_2d(torch.from_numpy(x),
                                    torch.from_numpy(u)).numpy())
    np.testing.assert_array_equal(got, _bits(pallas))
    flat = got.reshape(-1)
    np.testing.assert_array_equal(flat[:5], x.reshape(-1).view(U32)[:5])
    assert set(flat[8:16]) == {0x7F800000}         # +Inf by the carry
    assert set(flat[16:24]) == {0xFF800000}
    assert set(flat[5:7] & 0x7FFFFFFF) <= {0, 0x00800000}   # rounded


def test_natural_2d_subnormal_rule_against_the_oracle():
    """The jitted oracle equals the port bit for bit, subnormals included
    (they round); evaluated eagerly, op by op, it passes the subnormals
    through (XLA:CPU's denormals-are-zero ``x == 0``) and differs there
    only."""
    x, u = _special(seed=2)
    xj, uj = jnp.asarray(x), jnp.asarray(u)
    jitted = _bits(np.asarray(jax.jit(jnatural_ref)(xj, uj)))
    eager = _bits(np.asarray(jnatural_ref(xj, uj)))
    got = _bits(natural_compress_2d_ref(torch.from_numpy(x),
                                        torch.from_numpy(u)).numpy())
    sub = (np.abs(x) < np.finfo(np.float32).tiny) & (x != 0)
    assert sub.sum() == 34          # 1e-40, -1e-42 and 32 random mantissas
    np.testing.assert_array_equal(got, jitted)
    np.testing.assert_array_equal(got[~sub], eager[~sub])
    np.testing.assert_array_equal(eager[sub], _bits(x)[sub])


def test_natural_2d_bf16_and_any_shape():
    x, u = _special(n=2, b=64, seed=4)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    pallas = np.asarray(jnatural_2d(xb, jnp.asarray(u), interpret=True))
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))) \
        .to(torch.bfloat16)
    got = natural_compress_2d(xt, torch.from_numpy(u))
    assert got.dtype == torch.bfloat16
    want = pallas.view(np.int16)
    nan = np.isnan(np.asarray(xb.astype(jnp.float32)))
    np.testing.assert_array_equal(got.view(torch.int16).numpy()[~nan],
                                  want[~nan])
    # elementwise: any contiguous shape gives the 2-D result reshaped
    y3 = natural_compress_2d(torch.from_numpy(x.reshape(2, 4, 16)),
                             torch.from_numpy(u.reshape(2, 4, 16)))
    np.testing.assert_array_equal(
        _bits(y3.numpy()).reshape(2, 64),
        _bits(natural_compress_2d(torch.from_numpy(x),
                                  torch.from_numpy(u)).numpy()))


# --------------------------------------------------------------------------
# the wrappers
# --------------------------------------------------------------------------

def test_wrappers_check_shapes_and_dtypes():
    x, u = torch.zeros(2, 128), torch.zeros(2, 128)
    bad = [
        lambda: qsgd_dequantized(x.double(), u),
        lambda: qsgd_dequantized(x, u.double()),
        lambda: qsgd_dequantized(x, torch.zeros(2, 64)),
        lambda: qsgd_dequantized(x[None], u[None]),
        lambda: qsgd_dequantized(torch.zeros(128, 2).T, u),
        lambda: qsgd_dequantized(x, u, levels=0),
        lambda: qsgd_dequantized(x, u, norms_out=torch.zeros(3, 1)),
        lambda: natural_compress_2d(x.double(), u),
        lambda: natural_compress_2d(x, u.to(torch.bfloat16)),
        lambda: natural_compress_2d(x, torch.zeros(2, 64)),
        lambda: natural_compress_2d(torch.zeros(128, 2).T, u),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    meta = torch.empty(2, 128, device="meta")
    for call in (lambda: qsgd_dequantized(meta, meta),
                 lambda: natural_compress_2d(meta, meta)):
        with pytest.raises(ValueError, match="no kernel"):
            call()


def test_cpu_runs_the_plain_versions_without_launching():
    before = dict(LAUNCHES)
    x, u = torch.randn(3, 256), torch.rand(3, 256)
    norms = torch.empty(3, 1)
    y = qsgd_dequantized(x, u, levels=300, norms_out=norms)
    want, want_norms = dequantize_with_noise(x, u, 300)
    assert torch.equal(y, want) and torch.equal(norms, want_norms)
    assert torch.equal(natural_compress_2d(x, u),
                       natural_compress_2d_ref(x, u))
    assert qsgd_dequantized(torch.zeros(0, 8), torch.zeros(0, 8)).shape \
        == (0, 8)
    assert dict(LAUNCHES) == before


# --------------------------------------------------------------------------
# the chunked threefry draws
# --------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [1, 3, 64, 1000, prng.DRAW_CHUNK])
def test_draws_equal_across_chunk_sizes(chunk, monkeypatch):
    monkeypatch.setattr(prng, "DRAW_CHUNK", chunk)
    keys = prng.split(prng.PRNGKey(4), 3)
    for key, shape in ((keys, (5, 77)), (keys[0], (130,)), (keys, ()),
                       (keys[1], (0, 4))):
        bits = prng.tensor_bits(key, shape)
        np.testing.assert_array_equal(bits.numpy().astype(U32),
                                      prng.random_bits(key, shape))
        np.testing.assert_array_equal(
            prng.tensor_uniform(key, shape).numpy(),
            prng.uniform(key, shape))
        np.testing.assert_array_equal(
            prng.tensor_bernoulli(key, 0.3, shape).numpy(),
            prng.bernoulli(key, 0.3, shape))


def test_draw_matches_jax_across_chunks(monkeypatch):
    monkeypatch.setattr(prng, "DRAW_CHUNK", 50)
    keys = jax.random.split(jax.random.PRNGKey(8), 2)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (9, 31)))(
        keys))
    got = prng.tensor_uniform(np.asarray(keys), (9, 31))
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# the routed leafwise codecs
# --------------------------------------------------------------------------

def _leaf(n=3, shape=(40, 130), seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n,) + shape).astype(np.float32)
    x[0, :5] = 0.0                      # a zero bucket at bucket 512
    return x


@pytest.mark.parametrize("levels,bucket", [(127, 2048), (7, 512),
                                           (300, 512), (1, 100)])
def test_routed_qsgd_apply_against_the_jitted_reference(levels, bucket):
    x = _leaf(seed=levels)
    keys = jax.random.split(jax.random.PRNGKey(levels), 3)
    jc = jcomp.QSGD(levels=levels, bucket=bucket)
    want = np.asarray(jax.jit(jax.vmap(jc.apply))(keys, jnp.asarray(x)))
    jp = jax.jit(jax.vmap(jc.encode))(keys, jnp.asarray(x))
    tc = tcomp.QSGD(levels=levels, bucket=bucket)
    got = tc.apply(np.asarray(keys), torch.from_numpy(x)).numpy()
    assert got.shape == x.shape
    # layered: equal by value where the bucket norms agree, within one
    # level of the reference's norm elsewhere
    tp = tc.encode(np.asarray(keys), torch.from_numpy(x))
    jn, tn = np.asarray(jp.norms), tp.norms.numpy()
    assert _ulps(tn, jn) <= NORM_ULPS
    d = x[0].size
    per_el = lambda a: np.repeat(a[..., 0], bucket, axis=-1)[:, :d] \
        .reshape(x.shape)
    same = per_el(jn == tn)
    np.testing.assert_array_equal(got[same], want[same])
    assert np.all(np.abs(got - want) <= per_el(jn) / levels * 1.000001)
    # and decode(encode) of the port's own payload, by value
    np.testing.assert_array_equal(got, tc.decode(tp).numpy())


def test_routed_natural_apply_against_the_jitted_reference():
    x = _leaf(seed=9)
    keys = jax.random.split(jax.random.PRNGKey(9), 3)
    jc = jcomp.Natural()
    want = np.asarray(jax.jit(jax.vmap(jc.apply))(keys, jnp.asarray(x)))
    got = tcomp.Natural().apply(np.asarray(keys), torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("name", ["qsgd", "natural"])
def test_one_kernel_call_per_leaf_for_the_whole_client_batch(name,
                                                            monkeypatch):
    """A leafwise apply calls its kernel's wrapper once, with every
    client's buckets (or elements) in one buffer."""
    wrapper = {"qsgd": "qsgd_dequantized",
               "natural": "natural_compress_2d"}[name]
    seen = []
    real = getattr(tcomp, wrapper)

    def spy(x, noise, **kw):
        seen.append(tuple(x.shape))
        return real(x, noise, **kw)

    monkeypatch.setattr(tcomp, wrapper, spy)
    x = torch.from_numpy(_leaf(n=2, shape=(3, 1000)))
    keys = prng.split(prng.PRNGKey(1), 2)
    tcomp.make_compressor(name).apply(keys, x)
    assert seen == ([(2 * 2, 2048)] if name == "qsgd" else [(2, 3, 1000)])
