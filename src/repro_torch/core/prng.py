"""The protocol's threefry key schedule, reproduced bit-exactly on the host.

Every random stream of compressed L2GD — the xi draws, the per-step
compressor keys, the per-client uplink keys — is a threefry2x32 key
derived from one protocol key (DESIGN.md §6 and §8).  The port keeps
these streams integer-exact with the JAX reference instead of drawing
from a ``torch.Generator``: a key is a numpy ``(2,)`` uint32 array (a batch
of keys is ``(..., 2)``), and the schedule below reproduces, for
``jax_threefry_partitionable=True`` (the default since jax 0.5):

  * ``jax.random.PRNGKey(seed)``   -> :func:`PRNGKey`
  * ``jax.random.split(key, n)``   -> :func:`split`
  * ``jax.random.fold_in(key, i)`` -> :func:`fold_in`
  * ``jax.random.bits`` (32-bit)   -> :func:`random_bits`
  * ``jax.random.uniform`` (f32)   -> :func:`uniform`
  * ``jax.random.bernoulli``       -> :func:`bernoulli`
  * ``jax.random.randint`` (int32) -> :func:`randint`
  * ``jax.random.normal`` (f32)    -> :func:`normal`, within
    :data:`NORMAL_ULPS`

Keys are a few bytes, so the schedule runs in numpy ``uint32`` (which
wraps natively) and never touches the device; the kernels receive the
two words of ``flatbuf.seeds_of(key)`` as scalar arguments.

Array-sized draws — the noise of the leafwise codecs — are made on the
device of the tensor they perturb, from the same keys:

  * ``jax.random.bits`` (32-bit)   -> :func:`tensor_bits`
  * ``jax.random.uniform`` (f32)   -> :func:`tensor_uniform`
  * ``jax.random.bernoulli``       -> :func:`tensor_bernoulli`
  * ``jax.random.normal`` (f32)    -> :func:`tensor_normal`
  * ``jax.random.permutation(key, d)`` -> :func:`permutation`

On a CUDA device each draw is one launch of the ``threefry_draw``
kernel (``kernels/threefry``), which hashes every counter in registers
and writes the finished draw; on the CPU it is the kernel's plain
version, :func:`_draw_plain`: uint32 words in int64 tensors masked to 32
bits (torch's CPU ``uint32`` lacks ``+`` and ``>>``), over the counter
range in chunks of :data:`DRAW_CHUNK`.  Each array draw is one ``draw``
span of ``repro_torch.tracing`` and adds the counters it hashes to
``draw.elements``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.kernels.threefry import kernel as threefry
from repro_torch.kernels.dispatch import use_kernel

__all__ = ["PRNGKey", "threefry2x32", "split", "fold_in", "random_bits",
           "uniform", "bernoulli", "randint", "normal", "NORMAL_ULPS",
           "tensor_bits", "tensor_uniform", "tensor_bernoulli",
           "tensor_normal", "permutation"]

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = _U32(0x1BD11BDA)


def _rotl(x, r: int):
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block (20 rounds) on broadcastable uint32
    arrays: key words ``(k1, k2)``, counter words ``(x1, x2)``.  Returns
    the two output words as uint32 arrays of the broadcast shape."""
    k1, k2, x1, x2 = np.broadcast_arrays(*(np.asarray(a, _U32)
                                           for a in (k1, k2, x1, x2)))
    shape = k1.shape
    # 1-d arrays throughout: uint32 array arithmetic wraps silently,
    # numpy scalar arithmetic would warn on every wrap
    k1, k2, x1, x2 = (a.reshape(-1) for a in (k1, k2, x1, x2))
    ks = [k1, k2, k1 ^ k2 ^ _PARITY]
    x = [x1 + ks[0], x2 + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0].reshape(shape), x[1].reshape(shape)


def PRNGKey(seed: int) -> np.ndarray:
    """Raw key words of ``jax.random.PRNGKey(seed)`` for an int32 seed:
    the high word is ``seed >> 32`` (0 for every int32 seed) and the low
    word is the seed's bit pattern."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is outside the int32 range the "
                         "reference accepts without jax_enable_x64")
    return np.array([0, seed & 0xFFFFFFFF], _U32)


def _words(key):
    key = np.asarray(key, _U32)
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key is (..., 2) uint32 words, got {key.shape}")
    return key[..., 0], key[..., 1]


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` -> (num, 2) uint32 keys; a batch of
    keys (..., 2) gives (..., num, 2), the reference's vmap of split."""
    k1, k2 = _words(key)
    lo = np.arange(int(num), dtype=_U32)
    y1, y2 = threefry2x32(k1[..., None], k2[..., None], np.zeros_like(lo), lo)
    return np.stack([y1, y2], axis=-1)


def fold_in(key, data) -> np.ndarray:
    """``jax.random.fold_in(key, data)``.  ``data`` may be an int or an
    integer array (values taken modulo 2^32, as the reference converts
    them to uint32); an array gives one key per element, (..., 2)."""
    k1, k2 = _words(key)
    d = np.asarray(np.asarray(data, np.int64) & 0xFFFFFFFF, _U32)
    y1, y2 = threefry2x32(k1, k2, np.zeros_like(d), d)
    return np.stack([y1, y2], axis=-1)


def random_bits(key, shape=()) -> np.ndarray:
    """32-bit ``jax.random.bits(key, shape)`` in partitionable mode: the
    64-bit iota of the shape, split into (hi, lo) counter words, hashed,
    and the two output words XORed.  A batch of keys (..., 2) gives
    bits of shape ``batch + shape``."""
    k1, k2 = _words(key)
    shape = tuple(int(s) for s in shape)
    count = np.arange(int(np.prod(shape, dtype=np.int64)),
                      dtype=np.uint64).reshape(shape)
    hi = (count >> np.uint64(32)).astype(_U32)
    lo = (count & np.uint64(0xFFFFFFFF)).astype(_U32)
    kshape = k1.shape + (1,) * len(shape)
    y1, y2 = threefry2x32(k1.reshape(kshape), k2.reshape(kshape), hi, lo)
    return y1 ^ y2


def uniform(key, shape=()) -> np.ndarray:
    """float32 ``jax.random.uniform(key, shape)`` on [0, 1): the top 23
    bits as the mantissa of a float in [1, 2), minus one."""
    bits = random_bits(key, shape)
    floats = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32)
    return np.maximum(np.float32(0.0), floats - np.float32(1.0))


def bernoulli(key, p, shape=()) -> np.ndarray:
    """``jax.random.bernoulli(key, p)`` with ``p`` compared in float32,
    as the reference compares the float32 ``hp.p``."""
    return uniform(key, shape) < np.float32(p)


def randint(key, shape, minval, maxval) -> np.ndarray:
    """int32 ``jax.random.randint(key, shape, minval, maxval)``: two
    32-bit draws a value (from ``split(key)``'s two keys), reduced into
    the span with the reference's uint32 arithmetic, which wraps:
    ``(hi % span) * (2^32 % span) + lo % span``, modulo the span, where
    ``2^32 % span`` is formed as ``((2^16 % span)^2) % span``.  A span
    that is not a power of two is slightly biased, as in the reference;
    ``maxval <= minval`` gives ``minval``."""
    shape = tuple(int(s) for s in shape)
    lo_b, hi_b = (np.broadcast_to(np.asarray(v, np.int64), shape)
                  for v in (minval, maxval))
    for v in (lo_b, hi_b):
        if v.size and (v.min() < -2 ** 31 or v.max() >= 2 ** 31):
            raise ValueError("randint bounds must lie in the int32 range")
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    lo32 = lo_b.astype(np.int32)
    span = np.asarray((hi_b - lo_b) & 0xFFFFFFFF, _U32).reshape(-1)
    span = np.where(hi_b.reshape(-1) <= lo_b.reshape(-1), _U32(1), span)
    higher, lower = higher.reshape(-1), lower.reshape(-1)
    mult = np.full_like(span, 1 << 16) % span
    mult = (mult * mult) % span          # uint32 arrays wrap, as lax.mul
    offset = ((higher % span) * mult + lower % span) % span
    return (lo32.reshape(-1) + offset.view(np.int32)).reshape(shape)


# --------------------------------------------------------------------------
# normal draws: sqrt(2) erfinv(u), u uniform on [nextafter(-1, 0), 1)
# --------------------------------------------------------------------------

#: the least float32 above -1: the low end of the reference's uniform
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))
#: XLA's float32 erfinv (Giles' approximation): a degree-8 polynomial in
#: w - 2.5 where w = -log1p(-x^2) < 5, else in sqrt(w) - 3
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)
# XLA's constants are float32
_ERFINV_SMALL, _ERFINV_LARGE = (tuple(float(np.float32(c)) for c in cs)
                                for cs in (_ERFINV_SMALL, _ERFINV_LARGE))
#: ulps from ``jax.random.normal`` (XLA:CPU, jax 0.9.0) that a normal
#: draw is held to (tests/test_torch_encdec.py measures 3 at the train
#: CLI's keys and shapes, 99% of values bit-exact through torch, 98.7%
#: through numpy): the uniform is bit-exact and each multiply-add of the
#: polynomial is rounded once, as XLA contracts them into FMAs; what
#: remains is the log1p, which XLA does not round correctly
NORMAL_ULPS = 4


def _erfinv32(x, lib, wide, narrow):
    """XLA's float32 ``erf_inv`` of ``x`` (a float32 numpy array or
    tensor) written with ``lib`` (numpy or torch); ``wide`` / ``narrow``
    convert to float64 / float32, where each step of the polynomial is
    one rounding of ``c + p * w`` (an FMA: the float64 product of two
    float32 values is exact)."""
    w = -lib.log1p(-x * x)
    small = w < 5.0
    ws = lib.where(small, w - 2.5, lib.sqrt(w) - 3.0)
    w64 = wide(ws)

    def poly(coeffs):
        p = ws * 0.0 + coeffs[0]
        for c in coeffs[1:]:
            p = narrow(wide(p) * w64 + c)
        return p

    return lib.where(small, poly(_ERFINV_SMALL), poly(_ERFINV_LARGE)) * x


def normal(key, shape=()) -> np.ndarray:
    """float32 ``jax.random.normal(key, shape)``: ``uniform`` bits mapped
    to [nextafter(-1, 0), 1) as ``f * 2 + lo`` (``hi - lo`` rounds to 2
    in float32, so the product is exact and an FMA changes nothing),
    then ``sqrt(2) * erfinv``; within :data:`NORMAL_ULPS` of the
    reference."""
    u = np.maximum(np.float32(_NORMAL_LO),
                   uniform(key, shape) * np.float32(2.0)
                   + np.float32(_NORMAL_LO))
    return np.float32(_SQRT2) * _erfinv32(
        u, np, lambda t: t.astype(np.float64),
        lambda t: t.astype(np.float32))


# --------------------------------------------------------------------------
# array-sized draws on the device
# --------------------------------------------------------------------------

_MASK = 0xFFFFFFFF


def _rotl_tensor(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def _threefry_tensor(k1, k2, x1, x2):
    """:func:`threefry2x32` on broadcastable int64 tensors of uint32 words."""
    ks = [k1, k2, k1 ^ k2 ^ int(_PARITY)]
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl_tensor(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x[0], x[1]


#: counters per chunk of the plain version: every int64 temporary of the
#: threefry rounds holds batch x DRAW_CHUNK words, not the whole array
DRAW_CHUNK = 1 << 22

#: "elements": the counters the array draws hashed
DRAWN = tracing.counter("draw")


@tracing.traced("draw")
def _draw(key, shape, device, finish, offset=0, p=0.0) -> torch.Tensor:
    """``finish`` ("bits", "uniform" or "bernoulli" against the float32
    ``p``) of :func:`random_bits` on ``device``, of shape ``batch +
    shape``.  A CUDA device runs the ``threefry_draw`` kernel, one launch;
    the CPU runs the plain version, :func:`_draw_plain`; any other device
    raises.  In partitionable threefry element i depends only on its
    counter i, so ``offset`` draws the counters from ``offset`` on: the
    elements ``offset`` onward of a larger draw with the same key."""
    keys = np.asarray(key, _U32)
    _words(keys)
    batch = keys.shape[:-1]
    shape = tuple(int(s) for s in shape)
    total = math.prod(shape)
    offset = int(offset)
    if not 0 <= offset <= 2 ** 64 - total:
        raise ValueError(f"counters {offset} .. {offset} + {total} leave "
                         "the 64-bit range")
    out = torch.empty((math.prod(batch), total),
                      dtype=threefry.FINISHES[finish][1], device=device)
    rows = keys.reshape(-1, 2)
    if use_kernel(out):
        threefry.threefry_draw(rows, out, offset, finish, p)
    else:
        _draw_plain(rows, out, offset, finish, p)
    DRAWN["elements"] += out.numel()
    return out.reshape(batch + shape)


def _draw_plain(keys, out: torch.Tensor, offset: int, finish: str,
                p: float = 0.0) -> None:
    """The plain version of the ``threefry_draw`` kernel on any device:
    fill ``out`` (batch, total) with the draw of ``keys`` (batch, 2) as
    int64 tensors of uint32 words masked to 32 bits (torch's CPU
    ``uint32`` lacks ``+`` and ``>>``), DRAW_CHUNK counters at a time."""
    words = torch.from_numpy(np.asarray(keys, np.int64)).to(out.device) \
        .reshape(-1, 1, 2)
    total = out.shape[-1]
    for start in range(0, total, DRAW_CHUNK):
        stop = min(start + DRAW_CHUNK, total)
        base = offset + start
        # counted from the chunk's first low word (the sum stays under
        # 2^33), so no int64 overflows for counters past 2^63
        low = torch.arange(base & _MASK, (base & _MASK) + stop - start,
                           dtype=torch.int64, device=out.device)
        y1, y2 = _threefry_tensor(words[..., 0], words[..., 1],
                                  ((base >> 32) + (low >> 32)) & _MASK,
                                  low & _MASK)
        bits = y1 ^ y2
        if finish != "bits":
            bits = _to_uniform(bits)
            if finish == "bernoulli":
                bits = bits < p
        out[:, start:stop] = bits


def _to_uniform(bits: torch.Tensor) -> torch.Tensor:
    # the top 23 bits times 2^-23: the reference's mantissa trick minus
    # one, exactly
    return (bits >> 9).to(torch.float32) * (1.0 / (1 << 23))


def tensor_bits(key, shape, device=None) -> torch.Tensor:
    """:func:`random_bits` computed on ``device``: uint32 values (int64
    tensor) of shape ``batch + shape`` for keys (..., 2)."""
    return _draw(key, shape, device, "bits")


def tensor_uniform(key, shape, device=None, offset=0) -> torch.Tensor:
    """:func:`uniform` on ``device`` (float32); ``offset``: the draw's
    counters start there (see ``_draw``)."""
    return _draw(key, shape, device, "uniform", offset)


def tensor_bernoulli(key, p, shape, device=None, offset=0) -> torch.Tensor:
    """:func:`bernoulli` on ``device`` (``p`` compared in float32);
    ``offset`` as :func:`tensor_uniform`'s."""
    return _draw(key, shape, device, "bernoulli", offset,
                 float(np.float32(p)))


def tensor_normal(key, shape, device=None) -> torch.Tensor:
    """:func:`normal` on ``device`` (float32): the erfinv finish in
    PyTorch on :func:`tensor_uniform`'s draw."""
    u = torch.clamp(tensor_uniform(key, shape, device) * 2.0 + _NORMAL_LO,
                    min=_NORMAL_LO)
    return _SQRT2 * _erfinv32(u, torch, torch.Tensor.double,
                              torch.Tensor.float)


def permutation(key, d: int, device=None) -> torch.Tensor:
    """``jax.random.permutation(key, d)`` for an int ``d`` (int64 tensor;
    keys (..., 2) give (..., d)): ``ceil(3 ln d / ln(2^32 - 1))`` rounds,
    each ``key, subkey = split(key)`` and a STABLE sort of the indices by
    32-bit ``random_bits(subkey, (d,))``, as ``lax.sort_key_val`` does."""
    keys = np.asarray(key, _U32)
    d = int(d)
    rounds = int(np.ceil(3 * np.log(max(1, d))
                         / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(d, dtype=torch.int64, device=device) \
        .expand(keys.shape[:-1] + (d,))
    for _ in range(rounds):
        pair = split(keys)
        keys, sub = pair[..., 0, :], pair[..., 1, :]
        order = torch.sort(tensor_bits(sub, (d,), device), dim=-1,
                           stable=True).indices
        x = torch.gather(x, -1, order)
    return x
