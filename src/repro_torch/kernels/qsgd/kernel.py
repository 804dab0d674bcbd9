"""QSGD pack / fused / unpack / dequantized — wrappers of the CUDA
kernels in ``csrc/qsgd.cu``, the counterparts of
``repro.kernels.qsgd.kernel``.

  qsgd_fused   — quantize-dequantize one buffer in one launch
  qsgd_pack    — quantize to the int8 wire payload (codes + bucket
                 norms), batched over a leading client axis
  qsgd_unpack  — dequantize a payload; bit-exact vs qsgd_fused given the
                 same codes and norms
  qsgd_dequantized — quantize-dequantize with noise the caller gives
                 (the leafwise codec's threefry draw); any levels >= 1

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
plain version in ``ref.py`` (:mod:`repro_torch.kernels.dispatch`).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.dispatch import use_kernel
from repro_torch.kernels.qsgd.ref import (dequantize_with_noise,
                                          qsgd_fused_ref, qsgd_pack_ref,
                                          qsgd_unpack_ref)

__all__ = ["qsgd_dequantized", "qsgd_fused", "qsgd_pack", "qsgd_unpack"]

_P, _I64, _I32, _U32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_uint32)
_SIGNATURES = {
    "qsgd_pack": (_P, _P, _P, _P, _I64, _I64, _I64, _I32, _P),
    "qsgd_fused": (_P, _P, _U32, _U32, _I64, _I64, _I32, _P),
    "qsgd_unpack": (_P, _P, _P, _I64, _I64, _I32, _P),
    "qsgd_reduce": (_P, _P, _P, _P, _I64, _I64, _I64, _I32, _P),
    "qsgd_dequantized": (_P, _P, _P, _P, _I64, _I64, _I32, _I32, _P),
}


def launch(name: str, device: torch.device, *args) -> None:
    """Launch one kernel of ``csrc/qsgd.cu`` (counted and checked by
    :func:`repro_torch.kernels.dispatch.launch`)."""
    dispatch.launch("qsgd", name, _SIGNATURES[name], device, *args)


def check_levels(levels: int) -> None:
    if not 1 <= int(levels) <= 127:
        raise ValueError(f"levels={levels} does not fit the int8 payload "
                         "(1 <= levels <= 127)")


def _check_buffer(x: torch.Tensor, ndim: int, what: str) -> None:
    if x.dtype != torch.float32 or x.dim() != ndim or not x.is_contiguous():
        raise ValueError(f"{what} must be a contiguous float32 tensor of "
                         f"{ndim} dims, got {x.dtype} {tuple(x.shape)}")


def qsgd_fused(x2d: torch.Tensor, seeds, *, levels: int = 127):
    """Quantize-dequantize a (n_buckets, bucket) float32 buffer with the
    counter noise of ``seeds`` (two uint32 words)."""
    check_levels(levels)
    _check_buffer(x2d, 2, "x2d")
    s0, s1 = (int(w) for w in np.asarray(seeds, np.uint32).reshape(2))
    if not use_kernel(x2d):
        return qsgd_fused_ref(x2d, (s0, s1), levels=levels)
    out = torch.empty_like(x2d)
    if x2d.numel():
        nb, b = x2d.shape
        launch("qsgd_fused", x2d.device, x2d.data_ptr(), out.data_ptr(),
               s0, s1, nb, b, int(levels))
    return out


def qsgd_pack(x: torch.Tensor, seeds, *, levels: int = 127):
    """Quantize to the wire payload.  ``x`` is one buffer (nb, b) with
    ``seeds`` a pair of words, or a client batch (n, nb, b) with
    ``seeds`` (n, 2) — client i's flat index restarts at 0, as under the
    reference's vmap.  Returns (codes int8 like x, norms f32 (..., nb, 1))."""
    check_levels(levels)
    words = np.ascontiguousarray(seeds, np.uint32)
    batched = x.dim() == 3
    _check_buffer(x, 3 if batched else 2, "x")
    if words.shape != ((x.shape[0], 2) if batched else (2,)):
        raise ValueError(f"seeds {words.shape} do not match x {tuple(x.shape)}")
    if not use_kernel(x):
        if not batched:
            return qsgd_pack_ref(x, words, levels=levels)
        parts = [qsgd_pack_ref(x[i], words[i], levels=levels)
                 for i in range(x.shape[0])]
        return (torch.stack([c for c, _ in parts]),
                torch.stack([nrm for _, nrm in parts]))
    xb = x if batched else x[None]
    n, nb, b = xb.shape
    codes = torch.empty(xb.shape, dtype=torch.int8, device=x.device)
    norms = torch.empty((n, nb, 1), dtype=torch.float32, device=x.device)
    if xb.numel():
        seeds_dev = torch.from_numpy(words.reshape(n, 2).view(np.int32)) \
            .to(x.device)
        launch("qsgd_pack", x.device, xb.data_ptr(), codes.data_ptr(),
               norms.data_ptr(), seeds_dev.data_ptr(), n, nb, b, int(levels))
    if not batched:
        return codes[0], norms[0]
    return codes, norms


def qsgd_unpack(codes: torch.Tensor, norms: torch.Tensor, *,
                levels: int = 127):
    """Dequantize a (nb, b) payload: ``codes * (norms / levels)``."""
    check_levels(levels)
    if codes.dtype != torch.int8 or codes.dim() != 2 \
            or not codes.is_contiguous():
        raise ValueError(f"codes must be contiguous int8 (nb, b), got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    if norms.shape != (codes.shape[0], 1):
        raise ValueError(f"norms {tuple(norms.shape)} do not match codes "
                         f"{tuple(codes.shape)}")
    _check_buffer(norms, 2, "norms")
    if not use_kernel(codes, norms):
        return qsgd_unpack_ref(codes, norms, levels=levels)
    out = torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
    if codes.numel():
        nb, b = codes.shape
        launch("qsgd_unpack", codes.device, codes.data_ptr(),
               norms.data_ptr(), out.data_ptr(), nb, b, int(levels))
    return out


def qsgd_dequantized(x2d: torch.Tensor, noise: torch.Tensor, *,
                     levels: int = 127, norms_out=None) -> torch.Tensor:
    """Quantize-dequantize a (n_buckets, bucket) float32 or bfloat16
    buffer with the float32 uniform ``noise`` of its shape; returns x's
    dtype.  ``norms_out`` (optional (n_buckets, 1) float32) receives the
    bucket norms used, for the layered check against the plain version."""
    if int(levels) < 1:
        raise ValueError(f"levels={levels} must be >= 1")
    if x2d.dtype not in (torch.float32, torch.bfloat16) or x2d.dim() != 2 \
            or not x2d.is_contiguous():
        raise ValueError(f"x2d must be a contiguous float32 or bfloat16 "
                         f"tensor of 2 dims, got {x2d.dtype} "
                         f"{tuple(x2d.shape)}")
    _check_buffer(noise, 2, "noise")
    if noise.shape != x2d.shape:
        raise ValueError(f"noise {tuple(noise.shape)} does not match x2d "
                         f"{tuple(x2d.shape)}")
    if norms_out is not None:
        _check_buffer(norms_out, 2, "norms_out")
        if norms_out.shape != (x2d.shape[0], 1):
            raise ValueError(f"norms_out {tuple(norms_out.shape)} does not "
                             f"match x2d {tuple(x2d.shape)}")
    given = () if norms_out is None else (norms_out,)
    if not use_kernel(x2d, noise, *given):
        out, norms = dequantize_with_noise(x2d, noise, int(levels))
        if norms_out is not None:
            norms_out.copy_(norms)
        return out
    out = torch.empty_like(x2d)
    if x2d.numel():
        nb, b = x2d.shape
        launch("qsgd_dequantized", x2d.device, x2d.data_ptr(),
               noise.data_ptr(), out.data_ptr(),
               None if norms_out is None else norms_out.data_ptr(), nb, b,
               int(levels), int(x2d.dtype == torch.bfloat16))
    return out
