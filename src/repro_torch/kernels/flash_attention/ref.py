"""Plain PyTorch version of the flash-attention kernel — the counterpart of
``repro.kernels.flash_attention.ref``: dense float32 scores, -1e30
masking, softmax, ``p @ v``, cast to ``q.dtype``.

The reference divides the scores by ``math.sqrt(D)``; compiled, XLA turns
that into a multiply by the float32 reciprocal, which is what this
version (and the CUDA kernel) does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["NEG_INF", "attn_scale", "flash_attention_ref"]

NEG_INF = -1e30


def attn_scale(D: int) -> float:
    """float32(1 / sqrt(D)), as a Python float holding that value."""
    return float(np.float32(1.0) / np.float32(np.sqrt(D)))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """q: (B, H, S, D), k / v: (B, H, T, D) -> (B, H, S, D) in q.dtype.
    Query row i sits at position ``i + q_offset`` (keys at 0..T-1), so a
    slice of the query rows can be checked on its own."""
    S, D = q.shape[2], q.shape[3]
    T = k.shape[2]
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * attn_scale(D)
    qi = torch.arange(S, device=q.device)[:, None] + q_offset
    kj = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kj <= qi)
    if window is not None:
        mask = mask & (qi - kj < window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p, v.float()).to(q.dtype)
