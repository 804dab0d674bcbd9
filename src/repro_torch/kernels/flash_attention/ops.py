"""Dispatched (B, S, H, D)-layout entry point with GQA — the counterpart
of ``repro.kernels.flash_attention.ops``.

A CUDA tensor launches the hand-written kernel, whose tiles are chosen
per head dim to fit the shared memory of a Hopper block (the reference's
``autotune_attn_blocks`` sized its tiles to VMEM); a CPU tensor runs the
GQA repeat and the dense plain version, the reference's route off the
TPU.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels.flash_attention.kernel import flash_attention

__all__ = ["flash_attention_op"]


def flash_attention_op(q, k, v, *, causal: bool = True,
                       window: Optional[int] = None):
    """q: (B, S, H, D), k / v: (B, T, Kv, D) with H % Kv == 0.  Returns
    (B, S, H, D)."""
    return flash_attention(q, k, v, causal=causal, window=window)
