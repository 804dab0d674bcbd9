"""Parity of the port's QSGD kernels (their plain PyTorch versions, which
the CUDA kernels are held to on the card) with the JAX reference: the
interpret-mode Pallas kernels and the jnp oracles, on the same inputs.

The comparison is layered, because a bucket norm is a float sum whose
order differs between XLA:CPU, ``torch.sum`` and the GPU's tree:

  1. norms agree within NORM_ULPS units in the last place;
  2. codes (pack) and outputs (fused) are bit-exact given the SAME norms;
  3. unpack is bit-exact given identical payloads, and so is the reduce
     of one client; the reduce of n clients is bit-exact against the
     kernels' float32 specification and within n roundings of the
     reference, whose XLA:CPU build contracts multiply-adds into FMAs.

The reference divides by the constant ``levels`` as a multiply by its
float32 reciprocal (XLA's simplification); the port does the same.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from _torch_threads import torch_one_thread  # noqa: F401
from repro.kernels.qsgd.kernel import (qsgd_fused_pallas, qsgd_pack_pallas,
                                       qsgd_unpack_pallas)
from repro.kernels.qsgd.ops import qsgd_reduce_pallas
from repro.kernels.qsgd.ref import qsgd_reduce_ref as jax_reduce_ref
from repro_torch.kernels.dispatch import LAUNCHES, use_kernel
from repro_torch.kernels.qsgd.kernel import qsgd_fused, qsgd_pack, qsgd_unpack
from repro_torch.kernels.qsgd.ops import qsgd_reduce
from repro_torch.kernels.qsgd.ref import qsgd_fused_ref, qsgd_pack_ref

# a bucket norm is sqrt of a sum of <= 2048 float32 squares; summed in
# another order the sum moves by a few ulps and the sqrt halves that
NORM_ULPS = 4

SHAPES = {
    "zero-bucket": (4, 128),     # row 1 is all zeros
    "ragged-tail": (3, 2048),    # 5000 values padded to 3 buckets
    "lanes": (2, 384),
}


def _buffer(kind, seed=0):
    rng = np.random.default_rng(seed)
    nb, b = SHAPES[kind]
    if kind == "ragged-tail":
        flat = np.zeros(nb * b, np.float32)
        flat[:5000] = rng.normal(size=5000)
        return flat.reshape(nb, b)
    x = rng.normal(size=(nb, b)).astype(np.float32)
    if kind == "zero-bucket":
        x[1] = 0.0
    return x


SEEDS = np.array([0x12345678, 0x9ABCDEF0], np.uint32)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.max(np.abs(a - b) / np.spacing(np.maximum(np.abs(a), 1e-30)))


@pytest.mark.parametrize("levels", [1, 7, 127])
@pytest.mark.parametrize("kind", list(SHAPES))
def test_pack_layered(kind, levels):
    x = _buffer(kind)
    jc, jn = qsgd_pack_pallas(jnp.asarray(x), jnp.asarray(SEEDS),
                              levels=levels, interpret=True, hw_rng=False)
    jc, jn = np.array(jc), np.array(jn)
    tx = torch.from_numpy(x)
    codes, norms = qsgd_pack(tx, SEEDS, levels=levels)
    assert codes.dtype == torch.int8 and norms.shape == (x.shape[0], 1)
    assert _ulps(norms.numpy(), jn) <= NORM_ULPS
    given, _ = qsgd_pack_ref(tx, SEEDS, levels=levels,
                             norms=torch.from_numpy(jn))
    np.testing.assert_array_equal(given.numpy(), jc)
    # zero-norm buckets code to all zeros on both sides
    zero = jn[:, 0] == 0
    assert not codes.numpy()[zero].any()


@pytest.mark.parametrize("levels", [1, 7, 127])
@pytest.mark.parametrize("kind", list(SHAPES))
def test_fused_exact_given_norms(kind, levels):
    x = _buffer(kind, seed=1)
    want = np.asarray(qsgd_fused_pallas(jnp.asarray(x), jnp.asarray(SEEDS),
                                        levels=levels, interpret=True,
                                        hw_rng=False))
    _, jn = qsgd_pack_pallas(jnp.asarray(x), jnp.asarray(SEEDS),
                             levels=levels, interpret=True, hw_rng=False)
    got = qsgd_fused_ref(torch.from_numpy(x), SEEDS, levels=levels,
                         norms=torch.from_numpy(np.array(jn)))
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper's own norms: outputs within one level of the reference
    out = qsgd_fused(torch.from_numpy(x), SEEDS, levels=levels).numpy()
    step = np.asarray(jn) / levels
    assert np.all(np.abs(out - want) <= step * (1 + 1e-6))


@pytest.mark.parametrize("kind", list(SHAPES))
def test_unpack_exact_and_matches_fused(kind):
    levels = 127
    x = _buffer(kind, seed=2)
    jc, jn = qsgd_pack_pallas(jnp.asarray(x), jnp.asarray(SEEDS),
                              levels=levels, interpret=True, hw_rng=False)
    want = np.asarray(qsgd_unpack_pallas(jc, jn, levels=levels,
                                         interpret=True))
    tc, tn = torch.from_numpy(np.array(jc)), torch.from_numpy(np.array(jn))
    got = qsgd_unpack(tc, tn, levels=levels)
    np.testing.assert_array_equal(got.numpy(), want)
    # the port's own pack -> unpack is its own fused, bit for bit
    codes, norms = qsgd_pack(torch.from_numpy(x), SEEDS, levels=levels)
    np.testing.assert_array_equal(
        qsgd_unpack(codes, norms, levels=levels).numpy(),
        qsgd_fused(torch.from_numpy(x), SEEDS, levels=levels).numpy())


def _stacked_payload(n, levels, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-levels, levels + 1, size=(n, 6, 128)) \
        .astype(np.int8)
    norms = rng.uniform(0.1, 5.0, size=(n, 6, 1)).astype(np.float32)
    norms[0, 2] = 0.0          # a zero-norm bucket
    return codes, norms


def _numpy_reduce(codes, norms, w, levels):
    """The kernels' arithmetic in numpy float32, one rounding per
    operation: acc + (c * (norm * f32(1/s))) * w, clients in order."""
    inv = np.float32(1.0 / levels)
    acc = np.zeros(codes.shape[1:], np.float32)
    for i in range(codes.shape[0]):
        y = codes[i].astype(np.float32) * (norms[i] * inv)
        if w is not None:
            y = y * w[i]
        acc = acc + y
    return acc


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n", [1, 3, 8])
def test_reduce_parity(n, weighted):
    """Bit-exact against the float32 specification of the kernel; against
    the JAX reference bit-exact for one client and within n roundings of
    the accumulator otherwise: XLA:CPU contracts some of the scan body's
    ``acc + y * w`` into FMAs, the port rounds the product (as the CUDA
    kernel, built with --fmad=false, does)."""
    levels = 7
    codes, norms = _stacked_payload(n, levels, seed=n)
    w = np.random.default_rng(100 + n).uniform(0, 2, size=n) \
        .astype(np.float32) if weighted else None
    jw = None if w is None else jnp.asarray(w)
    want = np.asarray(qsgd_reduce_pallas(jnp.asarray(codes),
                                         jnp.asarray(norms), jw,
                                         levels=levels, interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(jax_reduce_ref(jnp.asarray(codes),
                                        jnp.asarray(norms), jw,
                                        levels=levels)))
    got = qsgd_reduce(torch.from_numpy(codes), torch.from_numpy(norms),
                      None if w is None else torch.from_numpy(w),
                      levels=levels).numpy()
    np.testing.assert_array_equal(got, _numpy_reduce(codes, norms, w, levels))
    if n == 1:
        np.testing.assert_array_equal(got, want)
    else:
        # |partial sums| <= sum_i max|y_i|; one rounding of that per add
        bound = float(np.sum(np.abs(norms).max(axis=(1, 2))) *
                      (1 if w is None else np.abs(w).max()))
        assert np.max(np.abs(got - want)) <= n * np.spacing(np.float32(bound))


def test_batched_pack_is_per_client_pack():
    """Client i of a batched pack uses its own seeds and restarts the
    flat index at 0, as under the reference's vmap."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(3, 4, 128)).astype(np.float32))
    seeds = np.array([[1, 2], [3, 4], [5, 6]], np.uint32)
    codes, norms = qsgd_pack(x, seeds, levels=15)
    assert codes.shape == (3, 4, 128) and norms.shape == (3, 4, 1)
    for i in range(3):
        c, nrm = qsgd_pack(x[i], seeds[i], levels=15)
        assert torch.equal(codes[i], c) and torch.equal(norms[i], nrm)


def test_cpu_runs_plain_version_without_launching():
    before = dict(LAUNCHES)
    x = torch.ones(2, 128)
    codes, norms = qsgd_pack(x, SEEDS)
    qsgd_unpack(codes, norms)
    qsgd_fused(x, SEEDS)
    qsgd_reduce(codes[None], norms[None])
    assert dict(LAUNCHES) == before


@pytest.mark.parametrize("call", ["pack", "fused", "unpack", "reduce"])
def test_non_cpu_non_cuda_tensor_raises(call):
    """A wrapper never falls back to its plain version off the CPU: a
    tensor on any device but the CPU goes to the kernel or raises."""
    x = torch.empty(2, 128, device="meta")
    c = torch.empty(2, 128, dtype=torch.int8, device="meta")
    nrm = torch.empty(2, 1, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        if call == "pack":
            qsgd_pack(x, SEEDS)
        elif call == "fused":
            qsgd_fused(x, SEEDS)
        elif call == "unpack":
            qsgd_unpack(c, nrm)
        else:
            qsgd_reduce(c[None], nrm[None])


def test_wrapper_input_checks():
    x = torch.zeros(2, 128)
    with pytest.raises(ValueError, match="levels"):
        qsgd_pack(x, SEEDS, levels=128)
    with pytest.raises(ValueError):
        qsgd_fused(x.double(), SEEDS)
    with pytest.raises(ValueError):
        qsgd_pack(torch.zeros(2, 2, 128), SEEDS)      # seeds not (2, 2)
    with pytest.raises(ValueError):
        qsgd_unpack(torch.zeros(2, 128, dtype=torch.int8), torch.zeros(3, 1))
    with pytest.raises(ValueError):
        use_kernel(torch.zeros(1), torch.zeros(1, device="meta"))
