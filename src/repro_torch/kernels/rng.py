"""Counter-based RNG for the QSGD kernels' dither noise — the plain
PyTorch counterpart of ``repro.kernels.rng``.

    bits(i)    = fmix32((i * GOLDEN + s0) ^ s1)        (murmur3 finalizer)
    uniform(i) = (bits(i) >> 8) * 2^-24                in [0, 1)

``i`` is the element's flat index in the (n_buckets, bucket) view, taken
modulo 2^32 exactly as the uint32 arithmetic of the reference wraps, and
(s0, s1) are the two seed words of ``repro_torch.core.flatbuf.seeds_of``.
The CUDA kernels evaluate the same hash per element
(``kernels/qsgd/csrc/qsgd.cu``); this module is the whole-buffer
evaluation the plain versions and the CPU path use.

PyTorch's CPU ``uint32`` lacks ``+``, ``>>`` and ``<``, so the values live
in ``int64`` tensors holding uint32 bit patterns, and every operation that
could leave 32 bits is masked with ``& 0xFFFFFFFF``.  Multiplications are
split into 16-bit halves so that no int64 product overflows.
"""
from __future__ import annotations

import torch

__all__ = ["GOLDEN", "fmix32", "counter_bits", "bits_to_uniform",
           "counter_bits_2d", "counter_uniform_2d"]

GOLDEN = 0x9E3779B9          # 2^32 / golden ratio; odd -> bijective mul
_M1, _M2 = 0x85EBCA6B, 0xC2B2AE35  # murmur3 fmix32 constants
_MASK = 0xFFFFFFFF


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2^32 for int64 ``x`` in [0, 2^32) and a uint32 ``m``,
    without an int64 product that could overflow."""
    lo = (x & 0xFFFF) * m
    hi = (((x >> 16) * m) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    x = x ^ (x >> 16)
    return x


def counter_bits(idx: torch.Tensor, s0: int, s1: int) -> torch.Tensor:
    """uint32 hash (as int64) of (flat element index, seed pair)."""
    idx = idx.to(torch.int64) & _MASK
    return fmix32(((_mul32(idx, GOLDEN) + (int(s0) & _MASK)) & _MASK)
                  ^ (int(s1) & _MASK))


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """Top 24 bits -> float32 uniform in [0, 1) (exact in float32)."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def counter_bits_2d(seeds, shape, *, row_offset: int = 0,
                    device=None) -> torch.Tensor:
    """uint32 counter hashes (as int64) for a (rows, cols) window of the
    bucketed buffer.

    ``seeds`` is a pair of uint32 words; ``row_offset`` is the window's
    first global row.  Element (r, c) uses flat index
    ``(row_offset + r) * cols + c`` modulo 2^32, so any window of the same
    buffer yields the same stream as the whole."""
    rows, cols = int(shape[0]), int(shape[1])
    r = torch.arange(rows, dtype=torch.int64, device=device) + int(row_offset)
    c = torch.arange(cols, dtype=torch.int64, device=device)
    idx = ((r * cols) & _MASK)[:, None] + c[None, :]
    s0, s1 = (int(w) for w in seeds)
    return counter_bits(idx, s0, s1)


def counter_uniform_2d(seeds, shape, *, row_offset: int = 0,
                       device=None) -> torch.Tensor:
    """[0, 1) uniforms of :func:`counter_bits_2d`."""
    return bits_to_uniform(counter_bits_2d(seeds, shape,
                                           row_offset=row_offset,
                                           device=device))
