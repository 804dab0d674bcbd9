"""Flash attention forward — the wrapper of the CUDA kernel in
``csrc/flash_attention.cu``, the counterpart of
``repro.kernels.flash_attention.kernel.flash_attention``.

The kernel reads the model's own layout, q (B, S, H, D) and k / v
(B, T, Kv, D) with H % Kv == 0, through their strides (the last axis
contiguous), and writes a contiguous (B, S, H, D) output in q.dtype
(float32 or bfloat16).  Query head h reads KV head h // (H // Kv), the
reference's ``jnp.repeat`` without the copy.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the GQA
repeat and the plain version in ``ref.py`` — the route the reference's
``flash_attention_op`` takes off the TPU.

Like the reference's Pallas kernel, the CUDA op has no backward: a
gradient through it raises.  The CPU route keeps autograd.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.dispatch import use_kernel
from repro_torch.kernels.flash_attention.ref import (attn_scale,
                                                     flash_attention_ref)

__all__ = ["HEAD_DIMS", "TILES", "flash_attention"]

#: head dims the kernel is compiled for (the reference's tiles cover these)
HEAD_DIMS = (64, 128, 256)

#: head dim -> (query rows, keys) of the kernel's tiles (Tile<T, D>'s BQ
#: and BK in the source; the same for float32 and bfloat16)
TILES = {64: (128, 64), 128: (64, 32), 256: (64, 32)}

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURE = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
              *(_I64,) * 9, _I, _I, ctypes.c_float, _P)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, S, H, D) and k, v (B, T, Kv, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"k / v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (GQA needs H % Kv == 0)")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def _check_layout(t: torch.Tensor, what: str) -> None:
    """The kernel's 16-byte copies (cp.async): last axis contiguous,
    every other stride a multiple of 16 bytes, the base 16-byte aligned."""
    per = 16 // t.element_size()
    if t.stride(-1) != 1 or any(s % per for s in t.stride()[:-1]) \
            or t.data_ptr() % 16:
        raise ValueError(f"{what}: the kernel needs a contiguous last axis, "
                         f"strides in multiples of {per} elements and a base "
                         f"aligned to 16 bytes, got strides {t.stride()}")


def _plain(q, k, v, causal, window):
    rep = q.shape[2] // k.shape[2]
    if rep != 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    out = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal, window=window)
    return out.transpose(1, 2)


def _launch(q, k, v, causal: bool, window: Optional[int]) -> torch.Tensor:
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        _check_layout(t, what)
    B, S, H, D = q.shape
    T, Kv = k.shape[1], k.shape[2]
    if B * H > 65535:
        raise ValueError(f"B * H = {B * H} exceeds the grid's 65535")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0 or T == 0:
        return out.zero_()
    dispatch.launch("flash_attention", "flash_attention", _SIGNATURE,
                    q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), _DTYPES[q.dtype], B, S, T, H, Kv, D,
                    *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                    int(causal), 0 if window is None else int(window),
                    attn_scale(D))
    return out


class _FlashAttention(torch.autograd.Function):
    """The CUDA op.  Forward only, as the reference's Pallas kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        return _launch(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "the flash-attention kernel has no backward (nor has the "
            "reference's Pallas kernel); the slice of the port that trains "
            "the LM through run_l2gd trains with attn_impl='dense'")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (B, S, H, D), k / v (B, T, Kv, D) -> (B, S, H, D) in q.dtype.
    The kernel masks ragged edges, so its :data:`TILES` need not divide
    S or T.  ``window``: query i attends key j iff i - j < window."""
    _check(q, k, v, window)
    if not use_kernel(q, k, v):
        return _plain(q, k, v, causal, window)
    return _FlashAttention.apply(q, k, v, causal, window)
