"""Natural compression: fused round-trip and wire encode — wrappers of the
CUDA kernels in ``csrc/natural.cu``, the counterparts of
``repro.kernels.natural.kernel``.

  natural_fused — stochastically round |x| to a power of two in one
                  launch (the flat transport's ``apply``)
  natural_pack  — the wire encode: uint8 biased-exponent codes plus the
                  packed sign bitmap, batched over a leading client axis;
                  ``natural_merge`` of its output equals natural_fused
  natural_compress_2d — the rounding with noise the caller gives (the
                  leafwise codec's threefry draw), any contiguous shape

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
plain version in ``ref.py`` (:mod:`repro_torch.kernels.dispatch`).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.dispatch import use_kernel
from repro_torch.kernels.natural.ref import (natural_compress_2d_ref,
                                             natural_fused_ref,
                                             natural_pack_ref)

__all__ = ["natural_compress_2d", "natural_fused", "natural_pack"]

_P, _I64, _I32, _U32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_uint32)
_SIGNATURES = {
    "natural_pack": (_P, _P, _P, _P, _I64, _I64, _P),
    "natural_fused": (_P, _P, _U32, _U32, _I64, _P),
    "natural_reduce": (_P, _P, _P, _P, _I64, _I64, _P),
    "natural_compress_2d": (_P, _P, _P, _I64, _I32, _P),
}


def launch(name: str, device: torch.device, *args) -> None:
    """Launch one kernel of ``csrc/natural.cu`` (counted and checked by
    :func:`repro_torch.kernels.dispatch.launch`)."""
    dispatch.launch("natural", name, _SIGNATURES[name], device, *args)


def check_wire(t: torch.Tensor, dtype, ndim: int, what: str) -> None:
    """Dtype, rank and contiguity of an operand."""
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dtype} tensor of "
                         f"{ndim} dims, got {t.dtype} {tuple(t.shape)}")


def check_aligned(t: torch.Tensor, what: str, alignment: int = 16) -> None:
    if t.data_ptr() % alignment:
        raise ValueError(f"{what} must start on a {alignment}-byte boundary "
                         "for the kernel's vector loads")


def _check_bucket(b: int) -> None:
    if b % 8:
        raise ValueError(f"bucket {b} is not a multiple of 8: the natural "
                         "wire packs 8 signs per byte")


def natural_fused(x2d: torch.Tensor, seeds) -> torch.Tensor:
    """Natural compression of one (n_buckets, bucket) float32 buffer with
    the counter noise of ``seeds`` (two uint32 words)."""
    check_wire(x2d, torch.float32, 2, "x2d")
    _check_bucket(x2d.shape[1])
    s0, s1 = (int(w) for w in np.asarray(seeds, np.uint32).reshape(2))
    if not use_kernel(x2d):
        return natural_fused_ref(x2d, (s0, s1))
    out = torch.empty_like(x2d)
    if x2d.numel():
        check_aligned(x2d, "x2d")
        launch("natural_fused", x2d.device, x2d.data_ptr(), out.data_ptr(),
               s0, s1, x2d.numel())
    return out


def natural_pack(x: torch.Tensor, seeds):
    """Wire encode.  ``x`` is one buffer (nb, b) with ``seeds`` a pair of
    words, or a client batch (n, nb, b) with ``seeds`` (n, 2) — client
    i's flat index restarts at 0, as under the reference's vmap.  Returns
    (exps uint8 like x, signs uint8 (..., nb, b // 8))."""
    words = np.ascontiguousarray(seeds, np.uint32)
    batched = x.dim() == 3
    check_wire(x, torch.float32, 3 if batched else 2, "x")
    _check_bucket(x.shape[-1])
    if words.shape != ((x.shape[0], 2) if batched else (2,)):
        raise ValueError(f"seeds {words.shape} do not match x "
                         f"{tuple(x.shape)}")
    if not use_kernel(x):
        if not batched:
            return natural_pack_ref(x, words)
        parts = [natural_pack_ref(x[i], words[i]) for i in range(x.shape[0])]
        return (torch.stack([e for e, _ in parts]),
                torch.stack([s for _, s in parts]))
    xb = x if batched else x[None]
    n = xb.shape[0]
    exps = torch.empty(xb.shape, dtype=torch.uint8, device=x.device)
    signs = torch.empty(xb.shape[:-1] + (xb.shape[-1] // 8,),
                        dtype=torch.uint8, device=x.device)
    if xb.numel():
        check_aligned(xb, "x")
        seeds_dev = torch.from_numpy(words.reshape(n, 2).view(np.int32)) \
            .to(x.device)
        launch("natural_pack", x.device, xb.data_ptr(), exps.data_ptr(),
               signs.data_ptr(), seeds_dev.data_ptr(), n, xb[0].numel())
    if not batched:
        return exps[0], signs[0]
    return exps, signs


def natural_compress_2d(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Natural compression of a contiguous float32 or bfloat16 tensor of
    any shape with the float32 uniform ``noise`` of its shape; returns
    x's dtype."""
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 or bfloat16 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    check_wire(noise, torch.float32, x.dim(), "noise")
    if noise.shape != x.shape:
        raise ValueError(f"noise {tuple(noise.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if not use_kernel(x, noise):
        return natural_compress_2d_ref(x, noise)
    out = torch.empty_like(x)
    if x.numel():
        launch("natural_compress_2d", x.device, x.data_ptr(),
               noise.data_ptr(), out.data_ptr(), x.numel(),
               int(x.dtype == torch.bfloat16))
    return out
