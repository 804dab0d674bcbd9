"""Parity of the port's random streams with the JAX reference: the
kernels' counter RNG (repro.kernels.rng) and the threefry key schedule
(jax.random) — both integer-exact, so every check here is bit for bit."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_threads import torch_one_thread  # noqa: F401
from repro.core.flatbuf import seeds_of as jax_seeds_of
from repro.kernels import rng as jrng
from repro_torch.convert import key_from_words
from repro_torch.core import prng
from repro_torch.core.flatbuf import seeds_of
from repro_torch.kernels import rng as trng

U32 = np.uint32


def _keys(count=60, seed=11):
    return np.asarray(jax.random.split(jax.random.PRNGKey(seed), count))


@pytest.mark.parametrize("start", [0, 12345, 2 ** 31 - 7, 2 ** 32 - 64])
def test_counter_bits_and_uniform_exact(start):
    """fmix32 / counter_bits / bits_to_uniform on indices up to and across
    2^32 (the uint32 wrap of the reference)."""
    idx = (np.arange(128, dtype=np.uint64) + start) % (2 ** 32)
    idx = idx.astype(U32)
    s0, s1 = U32(0xDEADBEEF), U32(0x01234567)
    want = np.asarray(jrng.counter_bits(jnp.asarray(idx), s0, s1))
    got = trng.counter_bits(torch.from_numpy(idx.astype(np.int64)), s0, s1)
    np.testing.assert_array_equal(got.numpy().astype(U32), want)
    np.testing.assert_array_equal(
        trng.fmix32(torch.from_numpy(idx.astype(np.int64))).numpy()
        .astype(U32), np.asarray(jrng.fmix32(jnp.asarray(idx))))
    np.testing.assert_array_equal(
        trng.bits_to_uniform(got).numpy(),
        np.asarray(jrng.bits_to_uniform(jnp.asarray(want))))


@pytest.mark.parametrize("shape,row_offset", [
    ((3, 128), 0), ((5, 2048), 7), ((2, 256), 2 ** 32 // 256 - 1),
    ((4, 96), 44739240),   # rows straddle the 2^32 flat-index wrap
])
def test_counter_uniform_2d_exact(shape, row_offset):
    seeds = np.array([0x9E3779B9, 42], U32)
    want = np.asarray(jrng.counter_uniform_2d(jnp.asarray(seeds), shape,
                                              row_offset=row_offset))
    got = trng.counter_uniform_2d(seeds, shape, row_offset=row_offset)
    np.testing.assert_array_equal(got.numpy(), want)


def test_counter_uniform_window_equals_whole():
    """A window with row_offset reproduces the rows of the whole buffer."""
    seeds = (3, 5)
    whole = trng.counter_uniform_2d(seeds, (10, 128))
    win = trng.counter_uniform_2d(seeds, (4, 128), row_offset=6)
    assert torch.equal(whole[6:], win)


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1, -1, -12345])
def test_prng_key_exact(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("num", [2, 3, 8])
def test_split_exact(num):
    for k in _keys():
        np.testing.assert_array_equal(
            prng.split(k, num), np.asarray(jax.random.split(k, num)))


@pytest.mark.parametrize("data", [0, 1, 499, 2 ** 31 - 1, 2 ** 32 - 2,
                                  2 ** 32 - 1])
def test_fold_in_exact(data):
    for k in _keys():
        np.testing.assert_array_equal(
            prng.fold_in(k, data),
            np.asarray(jax.random.fold_in(k, U32(data))))


def test_fold_in_vectorised_matches_vmap():
    k = jax.random.PRNGKey(9)
    ks = np.arange(300, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda i: jax.random.fold_in(k, i))(ks))
    np.testing.assert_array_equal(prng.fold_in(np.asarray(k), ks), want)


@pytest.mark.parametrize("shape", [(), (7,), (3, 5)])
def test_uniform_and_bits_exact(shape):
    for k in _keys():
        np.testing.assert_array_equal(prng.uniform(k, shape),
                                      np.asarray(jax.random.uniform(k, shape)))
        np.testing.assert_array_equal(prng.random_bits(k, shape),
                                      np.asarray(jax.random.bits(k, shape)))


@pytest.mark.parametrize("p", [0.01, 0.3, 0.5, 0.9])
def test_bernoulli_exact(p):
    """xi draws compare the uniform with p in float32, as hp.p is."""
    keys = _keys(200, seed=3)
    want = np.asarray(jax.vmap(
        lambda k: jax.random.bernoulli(k, jnp.asarray(p)))(keys))
    got = prng.bernoulli(keys, p)
    np.testing.assert_array_equal(got, want)


def test_seeds_of_exact():
    keys = _keys()
    np.testing.assert_array_equal(
        seeds_of(keys), np.stack([np.asarray(jax_seeds_of(k)) for k in keys]))
    np.testing.assert_array_equal(seeds_of(keys[0]),
                                  np.asarray(jax_seeds_of(keys[0])))


def test_key_from_words():
    k = jax.random.fold_in(jax.random.key(2), 5)
    words = key_from_words(np.asarray(jax.random.key_data(k)))
    np.testing.assert_array_equal(
        prng.split(words), np.asarray(jax.random.key_data(jax.random.split(k))))
    with pytest.raises(ValueError):
        key_from_words(np.zeros(3, np.int32))
