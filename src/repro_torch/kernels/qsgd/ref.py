"""Plain PyTorch versions of the QSGD kernels — the counterpart of
``repro.kernels.qsgd.ref``.

They keep the reference's exact operation order — ``abs(x) / safe * s``,
then ``floor``, then ``u < scaled - lo``, then ``sign * q``; dequantize is
``codes * (norm / s)`` with zero-norm buckets giving 0; the reduce adds
clients in index order 0..n-1 as ``acc + c * (norm / s) * w`` — and its
rounding: ``norm / s`` divides by a constant, which XLA compiles as
``norm * float32(1 / s)``, so the port multiplies by that reciprocal too.
On identical inputs they agree bit for bit with the JAX oracles and with
the CUDA kernels.  They are the CPU path behind the wrappers in
``kernel.py`` / ``ops.py`` and the surface ``chip_smoke.py`` holds each
kernel against on the card.

Two hooks exist for that layered comparison: ``norms=`` feeds given
bucket norms into the quantizer (the GPU's tree-reduced norm differs from
a sequential sum by ulps, which can move a code across a rounding
boundary), and ``row_offset=`` evaluates a window of rows of a larger
buffer with that buffer's noise stream.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.rng import counter_uniform_2d

__all__ = ["qsgd_dequantized_ref", "qsgd_fused_ref", "qsgd_pack_ref",
           "qsgd_unpack_ref", "qsgd_reduce_ref", "quantize_with_noise",
           "dequantize_with_noise", "level_scale"]


def level_scale(norms, levels: int):
    # the reference divides by the constant s as XLA compiles it: a
    # multiply by the float32 reciprocal of s, not an IEEE division
    return norms * float(np.float32(1.0 / levels))


def quantize_with_noise(x2d, noise, levels: int, norms=None):
    """(sign(x) * q as float32, bucket norms (..., nb, 1)) for buckets
    along the last axis, given the dither ``noise`` — shared with the
    leafwise QSGD codec, which draws its noise from threefry."""
    x = x2d.to(torch.float32)
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)) \
        if norms is None else norms
    safe = torch.where(norm == 0.0, torch.ones_like(norm), norm)
    scaled = torch.abs(x) / safe * float(levels)
    lo = torch.floor(scaled)
    q = lo + (noise < (scaled - lo)).to(torch.float32)
    return torch.sign(x) * q, norm


def dequantize_with_noise(x2d, noise, levels: int, norms=None):
    """(quantize-dequantize of ``x2d`` given ``noise``, in x's dtype;
    bucket norms): ``sign(x) * q * (norm / s)``, zero-norm buckets 0.
    Where x < 0 rounds to level 0 the value is -0.0, as in the
    reference's Pallas kernel; its leafwise codec, which goes through
    integer codes, gives +0.0 there."""
    codes, norm = quantize_with_noise(x2d, noise, levels, norms)
    out = codes * level_scale(norm, levels)
    out = torch.where(norm == 0.0, torch.zeros_like(out), out)
    return out.to(x2d.dtype), norm


def qsgd_dequantized_ref(x2d, noise, levels: int = 127, norms=None):
    """The explicit-noise kernel's function: quantize one (n_buckets,
    bucket) buffer (float32 or bfloat16) with the float32 ``noise`` of
    its shape, dequantize, cast back to x's dtype."""
    return dequantize_with_noise(x2d, noise, levels, norms)[0]


def _noise(x2d, seeds, row_offset):
    return counter_uniform_2d(seeds, x2d.shape, row_offset=row_offset,
                              device=x2d.device)


def qsgd_fused_ref(x2d, seeds, *, levels: int = 127, row_offset: int = 0,
                   norms=None):
    """Quantize-dequantize one (n_buckets, bucket) buffer with the
    counter noise of ``seeds``."""
    return qsgd_dequantized_ref(x2d, _noise(x2d, seeds, row_offset),
                                levels, norms)


def qsgd_pack_ref(x2d, seeds, *, levels: int = 127, row_offset: int = 0,
                  norms=None):
    """One buffer's wire payload: (codes int8 (nb, b), norms f32 (nb, 1))."""
    codes, norm = quantize_with_noise(x2d, _noise(x2d, seeds, row_offset),
                                      levels, norms)
    return codes.to(torch.int8), norm


def qsgd_unpack_ref(codes, norms, *, levels: int = 127):
    return codes.to(torch.float32) * level_scale(norms, levels)


def qsgd_reduce_ref(codes, norms, weights=None, *, levels: int = 127):
    """``sum_i w_i * codes_i * (norms_i / s)`` over the leading client
    axis of a stacked batch — codes (n, nb, b) int8, norms (n, nb, 1) —
    added in client order 0..n-1 into one (nb, b) float32 accumulator."""
    acc = torch.zeros(codes.shape[1:], dtype=torch.float32,
                      device=codes.device)
    for i in range(codes.shape[0]):
        y = codes[i].to(torch.float32) * level_scale(norms[i], levels)
        if weights is not None:
            y = y * weights[i]
        acc = acc + y
    return acc
