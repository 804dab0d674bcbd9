"""GQA attention (optional sliding window and qk-norm) with its KV cache —
the GQA half of ``repro.models.attention``.

Two execution paths:
  * train / prefill: full-sequence causal (optionally windowed) attention,
    dense (``attention_core`` with a mask) or through the flash-attention
    kernel (``impl="flash"``, no (S, S) mask is built);
  * decode: new tokens against a KV cache.  Windowed layers use a ring
    buffer of size ``window``.  The port writes the new keys and values
    into the cache tensors IN PLACE (the reference's
    ``dynamic_update_slice`` returns a new array) and returns the same
    cache object.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.models.blocks import (apply_rope, dense_init, init_rmsnorm,
                                       rmsnorm)

__all__ = ["NEG_INF", "attention_core", "causal_mask", "init_gqa", "KVCache",
           "init_kv_cache", "gqa_attention"]

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# core softmax attention
# ---------------------------------------------------------------------------

def attention_core(q, k, v, mask=None, scale=None):
    """q: (B,S,H,D), k/v: (B,T,K,D) with H % K == 0 (GQA repeat), mask
    broadcastable to (B,H,S,T).  fp32 softmax."""
    H, D = q.shape[2], q.shape[3]
    K = k.shape[2]
    if K != H:
        rep = H // K
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    scores = torch.einsum("bshd,bthd->bhst", q, k).float() * scale
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def causal_mask(S: int, T: int, window: Optional[int] = None,
                offset: int = 0, device=None) -> torch.Tensor:
    """(1,1,S,T) boolean; query i attends key j iff j <= i+offset and
    (no window or i+offset - j < window)."""
    qi = torch.arange(S, device=device)[:, None] + offset
    kj = torch.arange(T, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m = m & (qi - kj < window)
    return m[None, None]


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def init_gqa(generator, d_model: int, n_heads: int, n_kv: int, head_dim: int,
             dtype, *, device, qk_norm: bool = False,
             layout: str = "fused") -> dict:
    """layout='fused' stores (d, H*hd) projections; 'split' stores 3-D
    (d, H, hd); 'qkv_fused' one (d, (H+2Kv)*hd) input projection."""
    def w(shape):
        return dense_init(generator, shape, dtype, device=device)

    if layout == "qkv_fused":
        p = {"wqkv": w((d_model, (n_heads + 2 * n_kv) * head_dim)),
             "wo": w((n_heads * head_dim, d_model))}
    elif layout == "split":
        p = {"wq": w((d_model, n_heads, head_dim)),
             "wk": w((d_model, n_kv, head_dim)),
             "wv": w((d_model, n_kv, head_dim)),
             "wo": w((n_heads, head_dim, d_model))}
    else:
        p = {"wq": w((d_model, n_heads * head_dim)),
             "wk": w((d_model, n_kv * head_dim)),
             "wv": w((d_model, n_kv * head_dim)),
             "wo": w((n_heads * head_dim, d_model))}
    if qk_norm:
        p["q_norm"] = init_rmsnorm(head_dim, dtype, device)
        p["k_norm"] = init_rmsnorm(head_dim, dtype, device)
    return p


class KVCache(NamedTuple):
    k: torch.Tensor   # (B, C, Kv, D) — C = cache capacity (seq or window)
    v: torch.Tensor


def init_kv_cache(batch: int, capacity: int, n_kv: int, head_dim: int,
                  dtype, device) -> KVCache:
    shape = (batch, capacity, n_kv, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _project(params: dict, x, n_heads: int, n_kv: int, head_dim: int):
    B, S, _ = x.shape
    if "wqkv" in params:  # qkv_fused layout: q, k, v are views of one product
        qkv = x @ params["wqkv"]
        nq, nk = n_heads * head_dim, n_kv * head_dim
        return (qkv[..., :nq].reshape(B, S, n_heads, head_dim),
                qkv[..., nq:nq + nk].reshape(B, S, n_kv, head_dim),
                qkv[..., nq + nk:].reshape(B, S, n_kv, head_dim))
    if params["wq"].dim() == 3:  # split layout
        return tuple(torch.einsum("bsd,dhk->bshk", x, params[n])
                     for n in ("wq", "wk", "wv"))
    return ((x @ params["wq"]).reshape(B, S, n_heads, head_dim),
            (x @ params["wk"]).reshape(B, S, n_kv, head_dim),
            (x @ params["wv"]).reshape(B, S, n_kv, head_dim))


def gqa_attention(params: dict, x: torch.Tensor, positions: torch.Tensor, *,
                  n_heads: int, n_kv: int, head_dim: int, theta: float,
                  window: Optional[int] = None, qk_norm: bool = False,
                  cache: Optional[KVCache] = None,
                  cache_index: Optional[int] = None, ring: bool = False,
                  mask_override: Optional[torch.Tensor] = None,
                  impl: str = "dense"):
    """Returns (out, cache).  Train/prefill when cache is None.
    ``mask_override`` replaces the computed causal mask (the model passes
    its per-layer global / windowed mask).

    ``impl="flash"`` routes the train/prefill path through the
    flash-attention kernel with a static causal/window mask — callers
    select it only when the layer's mask is exactly
    ``causal_mask(S, S, window)`` (models/model.py gates it on
    ``cfg.sliding_window is None``).  Decode always takes the dense cache
    path; ``cache_index`` is the position of the first new token."""
    B, S, _ = x.shape
    q, k, v = _project(params, x, n_heads, n_kv, head_dim)
    if qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)

    if cache is None:
        if impl == "flash":
            from repro_torch.kernels.flash_attention.ops import \
                flash_attention_op
            out = flash_attention_op(q, k, v, causal=True, window=window)
        else:
            mask = mask_override if mask_override is not None \
                else causal_mask(S, S, window, device=x.device)
            out = attention_core(q, k, v, mask)
    else:
        C = cache.k.shape[1]
        idx = int(cache_index)
        slot = idx % C if ring else idx
        if slot + S > C:
            # the reference's dynamic_update_slice would clamp the start
            # and overwrite the newest slots; the port refuses instead
            raise IndexError(f"cache of capacity {C} cannot take {S} tokens "
                             f"at position {idx}")
        cache.k[:, slot:slot + S] = k
        cache.v[:, slot:slot + S] = v
        slots = torch.arange(C, device=x.device)
        if ring:
            # slot s holds position idx - ((idx - s) mod C); valid once written
            valid = idx - torch.remainder(idx - slots, C) >= 0
        else:
            valid = slots <= idx
        out = attention_core(q, cache.k, cache.v, valid[None, None, None, :])

    if params["wo"].dim() == 3:
        out = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    else:
        out = out.reshape(B, S, n_heads * head_dim) @ params["wo"]
    return out, cache
