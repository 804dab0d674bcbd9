"""Plain PyTorch versions of the natural-compression kernels — the
counterpart of ``repro.kernels.natural.ref``.

All three work in the uint32 bits domain (int64 tensors masked to 32
bits, as :mod:`repro_torch.kernels.rng` does), on the (n_buckets, 128)
view with ``row_offset`` for a window of a larger buffer:

  * rounding: zero the mantissa and bump the exponent iff
    ``(rbits >> 8) < 2 * mantissa`` — the reference's ``u < mantissa /
    2^23`` with u = (rbits >> 8) * 2^-24, both exact in float32 — where
    ``rbits`` is the counter hash of the element's flat index;
  * passthrough: a value keeps its bits only where its exponent field is
    255 (Inf, NaN); a zero has mantissa 0 and never bumps.  Subnormals
    round like every other finite value.  This needs no flush mode and
    equals the Pallas kernel in interpret mode and ``natural_pack_ref``;
    the reference's jitted ``natural_fused_ref`` differs on subnormals
    only, because XLA:CPU compiles ``x == 0.0`` with denormals-are-zero;
  * the reduce adds clients in index order 0..n-1 as ``acc + y * w``,
    the accumulator starting as client 0's term (XLA simplifies the
    reference's ``0 + y`` to ``y``, which keeps a -0.0); y is a power of
    two, so the product is exact and an FMA would give the same bits.

The reference's ``_wide_view`` is an XLA:CPU speed trick: the counter
stream is keyed by the flat index, which a row-major view leaves alone.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bits import (bits_float, float_bits, natural_merge,
                                      pack_bits, unpack_bits)
from repro_torch.kernels.rng import counter_bits_2d

__all__ = ["natural_compress_2d_ref", "natural_fused_ref",
           "natural_pack_ref", "natural_reduce_ref"]


def _rounded(x2d, seeds, row_offset):
    """(bits, rounded bits, special) of a (rows, cols) float32 window."""
    bits = float_bits(x2d)
    rbits = counter_bits_2d(seeds, x2d.shape, row_offset=row_offset,
                            device=x2d.device)
    special = (bits & 0x7F800000) == 0x7F800000
    up = ((rbits >> 8) < ((bits & 0x7FFFFF) << 1)) & ~special
    return bits, (bits & 0xFF800000) + (up.to(torch.int64) << 23), special


def natural_compress_2d_ref(x, noise):
    """Natural compression of ``x`` (float32 or bfloat16, any shape) with
    the float32 uniform ``noise`` of its shape: the exponent is bumped
    where ``noise < mantissa * 2^-23`` (both sides exact in float32), the
    passthrough rule above; the result in x's dtype (a power of two, a
    zero, Inf or NaN: exact in bfloat16 too)."""
    bits = float_bits(x)
    special = (bits & 0x7F800000) == 0x7F800000
    prob = (bits & 0x7FFFFF).to(torch.float32) * (1.0 / (1 << 23))
    up = (noise < prob) & ~special
    out = (bits & 0xFF800000) + (up.to(torch.int64) << 23)
    return bits_float(torch.where(special, bits, out)).to(x.dtype)


def natural_fused_ref(x2d, seeds, *, row_offset: int = 0):
    """Natural compression of one (n_buckets, bucket) float32 buffer with
    the counter noise of ``seeds`` (two uint32 words)."""
    bits, out, special = _rounded(x2d, seeds, row_offset)
    return bits_float(torch.where(special, bits, out))


def natural_pack_ref(x2d, seeds, *, row_offset: int = 0):
    """One-pass wire encode: (uint8 exponent codes (nb, b), packed sign
    bitmap (nb, b // 8)), never materializing the float32 output.  An
    exponent-254 carry gives code 255 (±Inf), as in the reference."""
    _, out, _ = _rounded(x2d, seeds, row_offset)
    exps = ((out >> 23) & 0xFF).to(torch.uint8)
    signs = ((out >> 31) & 1).to(torch.uint8)
    return exps, pack_bits(signs, 1)


def natural_reduce_ref(exps, signs, weights=None):
    """``sum_i w_i * merge(exps_i, signs_i)`` over the leading client axis
    of a stacked batch — exps (n, nb, b) uint8, signs (n, nb, b // 8)
    uint8, weights (n,) float32 or None — added in client order 0..n-1
    into one (nb, b) float32 accumulator, which starts as client 0's
    term (zeros for no clients)."""
    acc = torch.zeros(exps.shape[1:], dtype=torch.float32,
                      device=exps.device)
    for i in range(exps.shape[0]):
        y = natural_merge(exps[i], unpack_bits(signs[i], 1))
        if weights is not None:
            y = y * weights[i]
        acc = y if i == 0 else acc + y
    return acc
