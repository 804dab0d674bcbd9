"""The protocol's random streams, frozen here so that the reference works
them out again without the program.

Two generators feed compressed L2GD's codecs:

  * threefry2x32 in partitionable mode (the keys of every step, client
    and leaf, and the leafwise codecs' noise): ``split``, ``fold_in`` and
    ``uniform23`` below are ``jax.random``'s for raw uint32 key words;
  * a counter hash (the flat transport's kernels): element ``i`` of a
    client's bucketed buffer takes ``fmix32((i * GOLDEN + s0) ^ s1)``,
    murmur3's finalizer, with ``(s0, s1)`` folded from the key.

uint32 words live in int64 tensors masked to 32 bits, so one code path
serves the CPU and the card; array draws run ``CHUNK`` counters at a
time so no int64 temporary is the size of a leaf.
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
GOLDEN = 0x9E3779B9
_M1, _M2 = 0x85EBCA6B, 0xC2B2AE35
CHUNK = 1 << 22


def _threefry(k1, k2, x1, x2, mask):
    """Threefry-2x32, 20 rounds, on broadcastable arrays or tensors of
    uint32 words; ``mask`` keeps int64 tensors to 32 bits (numpy uint32
    wraps by itself and takes ``None``)."""
    def m(a):
        return a if mask is None else a & mask

    def rotl(a, r):
        return m((a << r) | (a >> (32 - r))) if mask is not None else \
            (a << _U32(r)) | (a >> _U32(32 - r))

    ks = [k1, k2, k1 ^ k2 ^ (_PARITY if mask is not None else _U32(_PARITY))]
    x = [m(x1 + ks[0]), m(x2 + ks[1])]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = m(x[0] + x[1])
            x[1] = rotl(x[1], r) ^ x[0]
        x[0] = m(x[0] + ks[(i + 1) % 3])
        bump = (i + 1) if mask is not None else _U32(i + 1)
        x[1] = m(x[1] + ks[(i + 2) % 3] + bump)
    return x[0], x[1]


def _host(k1, k2, x1, x2):
    arrays = np.broadcast_arrays(*(np.asarray(a, _U32) for a in (k1, k2, x1, x2)))
    shape = arrays[0].shape
    with np.errstate(over="ignore"):
        y1, y2 = _threefry(*(a.reshape(-1) for a in arrays), None)
    return y1.reshape(shape), y2.reshape(shape)


def key_of(seed: int) -> np.ndarray:
    """The run's protocol key: the seed's high and low 32-bit words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & MASK], _U32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split``: (..., 2) keys -> (..., num, 2)."""
    key = np.asarray(key, _U32)
    lo = np.arange(int(num), dtype=_U32)
    y1, y2 = _host(key[..., 0, None], key[..., 1, None], np.zeros_like(lo), lo)
    return np.stack([y1, y2], axis=-1)


def fold_in(key, data) -> np.ndarray:
    """``jax.random.fold_in`` of one key with an int or an int array."""
    key = np.asarray(key, _U32)
    d = np.asarray(np.asarray(data, np.int64) & MASK, _U32)
    y1, y2 = _host(key[..., 0], key[..., 1], np.zeros_like(d), d)
    return np.stack([y1, y2], axis=-1)


def step_keys(key, start: int, length: int) -> np.ndarray:
    """The compressor keys of global steps ``start .. start+length-1``:
    ``fold_in(split(key)[1], k)``."""
    noise_key = split(key)[1]
    return fold_in(noise_key, start + np.arange(length, dtype=np.int64))


def uniform23(key, numel: int, device) -> torch.Tensor:
    """float32 ``jax.random.uniform(key, (numel,))`` on ``device`` from
    the partitionable threefry stream: the top 23 bits of ``y1 ^ y2`` of
    counter i, times 2^-23."""
    k = np.asarray(key, _U32).astype(np.int64)
    k1, k2 = int(k[0]), int(k[1])
    out = torch.empty((numel,), dtype=torch.float32, device=device)
    for lo in range(0, numel, CHUNK):
        hi = min(lo + CHUNK, numel)
        count = torch.arange(lo, hi, dtype=torch.int64, device=device)
        y1, y2 = _threefry(k1, k2, count >> 32, count & MASK, MASK)
        out[lo:hi] = ((y1 ^ y2) >> 9).to(torch.float32) * (1.0 / (1 << 23))
    return out


def seeds_of(key) -> tuple:
    """The flat kernels' seed words of a (2,) key: (key[0], key[1] ^
    GOLDEN)."""
    k = np.asarray(key, _U32)
    return int(k[0]), int(k[1] ^ _U32(GOLDEN))


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    lo = (x & 0xFFFF) * m
    hi = (((x >> 16) * m) & 0xFFFF) << 16
    return (lo + hi) & MASK


def counter_bits(seeds, lo: int, hi: int, device) -> torch.Tensor:
    """The counter hash of flat indices ``lo .. hi-1`` (int64 holding
    uint32)."""
    s0, s1 = seeds
    x = torch.arange(lo, hi, dtype=torch.int64, device=device) & MASK
    x = ((_mul32(x, GOLDEN) + s0) & MASK) ^ s1
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)
