"""GQA attention (optional sliding window and qk-norm) with its KV cache,
DeepSeek-V2's multi-head latent attention (MLA) with its latent cache,
and the encoder-decoder's plain multi-head attention (bidirectional
self-attention and cross-attention) — the counterparts of
``repro.models.attention``.

Two execution paths:
  * train / prefill: full-sequence causal (optionally windowed) attention,
    dense (``attention_core`` with a mask) or through the flash-attention
    kernel (``impl="flash"``, no (S, S) mask is built);
  * decode: new tokens against a KV cache.  Windowed layers use a ring
    buffer of size ``window``.  The port writes the new keys and values
    into the cache tensors IN PLACE (the reference's
    ``dynamic_update_slice`` returns a new array) and returns the same
    cache object.

MLA has no flash route (the reference has none, and its q/k dim
nope + rope differs from its v dim): the prefill expands the latent into
keys and values and takes a dense causal softmax; decode takes the
absorbed form against the latent cache.  The encoder-decoder's
attention is dense too (``attention_core``), as the reference's.

On a model axis (``split``, a :class:`repro_torch.core.collective.
ModelSplit`; training only) an attention whose query projection is cut
on whole heads (H % k == 0) runs this process's H / k heads: the query
(and MHA's key and value, MLA's ``w_uk`` / ``w_uv``) columns of its
block, ``wo``'s rows, then the sum over the axis.  GQA's key and value
heads split too when n_kv % k == 0; otherwise ``wk`` / ``wv`` are made
whole and each process projects the kv heads its query heads read (their
gradients summed over the axis).  MLA's ``w_dkv`` and latent stay
replicated.  An attention whose heads do not divide makes its cut leaves
whole and runs every head on every process.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.models.blocks import (apply_rope, dense_init, init_rmsnorm,
                                       rmsnorm)

__all__ = ["NEG_INF", "attention_core", "causal_mask", "init_gqa", "KVCache",
           "init_kv_cache", "gqa_attention", "init_mla", "MLACache",
           "init_mla_cache", "mla_attention", "init_mha", "mha_attention",
           "heads_split", "kv_split"]

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


def heads_split(dims: dict, n_heads: int, size: int) -> bool:
    """Whether an attention of these cut dims runs on its block of the
    heads: the 2-D query projection cut and H % size == 0 (its block is
    then whole heads, and so are its other head-cut leaves')."""
    return "wqkv" not in dims and dims.get("wq") is not None \
        and n_heads % size == 0


def kv_split(dims: dict, n_kv: int, size: int) -> bool:
    """Whether GQA's key and value projections run on their block of the
    kv heads (n_kv % size == 0); else they are made whole."""
    return dims.get("wk") is not None and n_kv % size == 0


def _kv_heads(split, n_heads: int, n_kv: int):
    """The kv heads this process's query heads read: (first, last, the
    index into first..last of each local query head's, or None where
    the local heads take them evenly in order)."""
    local = n_heads // split.size
    group = n_heads // n_kv
    heads = range(split.index * local, (split.index + 1) * local)
    first, last = heads[0] // group, heads[-1] // group + 1
    idx = [h // group - first for h in heads]
    rep = local // (last - first)
    even = local % (last - first) == 0 and idx == [j // rep
                                                   for j in range(local)]
    return first, last, None if even else idx


def _project_heads(params: dict, h, split, n_heads: int, n_kv: int,
                   head_dim: int):
    """q, k, v of this process's block of the query heads
    (:func:`heads_split`) from ``h``, x through *f*: the kv heads' block
    where they split (:func:`kv_split`), else the kv heads its query
    heads read, projected from ``wk`` / ``wv`` made whole (their
    gradients summed over the axis)."""
    B, S, _ = h.shape
    q = (h @ params["wq"]).reshape(B, S, n_heads // split.size, head_dim)
    if kv_split(split.dims, n_kv, split.size):
        return (q,) + tuple((h @ params[n]).reshape(
            B, S, n_kv // split.size, head_dim) for n in ("wk", "wv"))
    first, last, idx = _kv_heads(split, n_heads, n_kv)
    cols = slice(first * head_dim, last * head_dim)
    k, v = ((h @ split.whole_partial(params[n], n)[:, cols])
            .reshape(B, S, last - first, head_dim) for n in ("wk", "wv"))
    if idx is not None:
        k, v = k[:, :, idx], v[:, :, idx]
    return q, k, v


def _write_cache(tensors, values, idx: int) -> None:
    """Write ``values`` at positions idx.. of the (B, C, ...) caches."""
    C, S = tensors[0].shape[1], values[0].shape[1]
    if idx + S > C:
        # the reference's dynamic_update_slice would clamp the start
        # and overwrite the newest slots; the port refuses instead
        raise IndexError(f"cache of capacity {C} cannot take {S} tokens "
                         f"at position {idx}")
    for t, v in zip(tensors, values):
        t[:, idx:idx + S] = v


def gqa_attention(params: dict, x: torch.Tensor, positions: torch.Tensor, *,
                  n_heads: int, n_kv: int, head_dim: int, theta: float,
                  window: Optional[int] = None, qk_norm: bool = False,
                  cache: Optional[KVCache] = None,
                  cache_index: Optional[int] = None, ring: bool = False,
                  mask_override: Optional[torch.Tensor] = None,
                  impl: str = "dense", split=None):
    """Returns (out, cache).  Train/prefill when cache is None; ``split``
    (training only) runs this process's heads of a model axis.
    ``mask_override`` replaces the computed causal mask (the model passes
    its per-layer global / windowed mask).

    ``impl="flash"`` routes the train/prefill path through the
    flash-attention kernel with a static causal/window mask — callers
    select it only when the layer's mask is exactly
    ``causal_mask(S, S, window)`` (models/model.py gates it on
    ``cfg.sliding_window is None``).  Decode always takes the dense cache
    path; ``cache_index`` is the position of the first new token."""
    if split is not None and not (params["wq"].dim() == 2 and heads_split(
            split.dims, n_heads, split.size)):
        params, split = split.whole(params), None
    B, S, _ = x.shape
    if split is None:
        q, k, v = _project(params, x, n_heads, n_kv, head_dim)
        q_norm, k_norm = params.get("q_norm"), params.get("k_norm")
    else:
        q, k, v = _project_heads(params, split.copy(x), split, n_heads, n_kv,
                                 head_dim)
        n_heads //= split.size
        if qk_norm:     # every local head reads them: partial gradients
            q_norm, k_norm = ({"scale": split.copy(params[n]["scale"])}
                              for n in ("q_norm", "k_norm"))
    if qk_norm:
        q = rmsnorm(q_norm, q)
        k = rmsnorm(k_norm, k)
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
        _write_cache(cache, (k, v), slot)
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
    return (out if split is None else split.reduce(out)), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------

def init_mla(generator, d_model: int, n_heads: int, kv_lora: int, dtype, *,
             device, nope_dim: int = 128, rope_dim: int = 64,
             v_dim: int = 128) -> dict:
    def w(shape):
        return dense_init(generator, shape, dtype, device=device)

    return {
        "wq": w((d_model, n_heads * (nope_dim + rope_dim))),
        "w_dkv": w((d_model, kv_lora + rope_dim)),
        "kv_norm": init_rmsnorm(kv_lora, dtype, device),
        "w_uk": w((kv_lora, n_heads * nope_dim)),
        "w_uv": w((kv_lora, n_heads * v_dim)),
        "wo": w((n_heads * v_dim, d_model)),
    }


class MLACache(NamedTuple):
    c_kv: torch.Tensor    # (B, C, kv_lora) — the compressed latent
    k_rope: torch.Tensor  # (B, C, rope_dim) — the one shared rope key


def init_mla_cache(batch: int, capacity: int, kv_lora: int, rope_dim: int,
                   dtype, device) -> MLACache:
    return MLACache(
        torch.zeros((batch, capacity, kv_lora), dtype=dtype, device=device),
        torch.zeros((batch, capacity, rope_dim), dtype=dtype, device=device))


def mla_attention(params: dict, x: torch.Tensor, positions: torch.Tensor, *,
                  n_heads: int, kv_lora: int, theta: float,
                  nope_dim: int = 128, rope_dim: int = 64, v_dim: int = 128,
                  cache: Optional[MLACache] = None,
                  cache_index: Optional[int] = None, split=None):
    """Latent attention.  Returns (out, cache): the cache is None on the
    prefill path and written in place on the decode path, whose scores
    are taken against the cached latent (q absorbed through ``w_uk``) and
    whose values are expanded from the latent through ``w_uv``.
    ``split`` (training only) runs this process's heads of a model axis:
    the latent is computed whole and enters the heads' products through
    *f*."""
    B, S, _ = x.shape
    H = n_heads
    scale = 1.0 / math.sqrt(nope_dim + rope_dim)
    xq = x
    if split is not None:
        if heads_split(split.dims, n_heads, split.size):
            H = n_heads // split.size
            xq = split.copy(x)
        else:
            params, split = split.whole(params), None

    q = (xq @ params["wq"]).reshape(B, S, H, nope_dim + rope_dim)
    q_nope, q_rope = q[..., :nope_dim], q[..., nope_dim:]
    q_rope = apply_rope(q_rope, positions, theta)

    dkv = x @ params["w_dkv"]
    # rmsnorm's default eps, as the reference calls it (not cfg.norm_eps)
    c_kv = rmsnorm(params["kv_norm"], dkv[..., :kv_lora])         # (B,S,R)
    # one rope key shared by every head
    k_rope = apply_rope(dkv[..., None, kv_lora:], positions, theta)[:, :, 0]
    if split is not None:
        c_kv, k_rope = split.copy(c_kv), split.copy(k_rope)

    if cache is None:
        k_nope = (c_kv @ params["w_uk"]).reshape(B, S, H, nope_dim)
        val = (c_kv @ params["w_uv"]).reshape(B, S, H, v_dim)
        scores = (torch.einsum("bshd,bthd->bhst", q_nope, k_nope)
                  + torch.einsum("bshd,btd->bhst", q_rope, k_rope))
        scores = scores.to(torch.float32) * scale
        scores = torch.where(causal_mask(S, S, device=x.device), scores,
                             NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(val.dtype)
        out = torch.einsum("bhst,bthd->bshd", probs, val)
    else:
        idx = int(cache_index)
        _write_cache(cache, (c_kv, k_rope), idx)
        cc, cr = cache
        C = cc.shape[1]
        wuk = params["w_uk"].reshape(kv_lora, H, nope_dim)
        q_abs = torch.einsum("bshd,rhd->bshr", q_nope, wuk)        # absorb
        scores = (torch.einsum("bshr,btr->bhst", q_abs, cc)
                  + torch.einsum("bshd,btd->bhst", q_rope, cr))
        scores = scores.to(torch.float32) * scale
        valid = (torch.arange(C, device=x.device) <= idx)[None, None, None]
        scores = torch.where(valid, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(cc.dtype)
        ctx_latent = torch.einsum("bhst,btr->bshr", probs, cc)     # (B,S,H,R)
        wuv = params["w_uv"].reshape(kv_lora, H, v_dim)
        out = torch.einsum("bshr,rhd->bshd", ctx_latent, wuv)

    out = out.reshape(B, S, H * v_dim) @ params["wo"]
    return (out if split is None else split.reduce(out)), cache


# ---------------------------------------------------------------------------
# plain MHA for the encoder and the cross attention (whisper)
# ---------------------------------------------------------------------------

def init_mha(generator, d_model: int, n_heads: int, head_dim: int, dtype, *,
             device) -> dict:
    def w(shape):
        return dense_init(generator, shape, dtype, device=device)

    return {"wq": w((d_model, n_heads * head_dim)),
            "wk": w((d_model, n_heads * head_dim)),
            "wv": w((d_model, n_heads * head_dim)),
            "wo": w((n_heads * head_dim, d_model))}


def mha_attention(params: dict, x: torch.Tensor, kv_src, *, n_heads: int,
                  head_dim: int, mask=None, precomputed_kv=None, split=None):
    """Bidirectional (``mask=None``), masked or cross attention of ``x``
    over ``kv_src``, no RoPE (the encoder-decoder adds its sinusoidal
    positions to the embeddings).  ``precomputed_kv`` = (k, v), each
    (B, T, H, D), replaces the key and value projections (the decode
    path's cross-attention caches).  ``split`` (training only) runs this
    process's heads of a model axis.  Returns (out, (k, v))."""
    B, S, _ = x.shape
    if split is not None:
        if heads_split(split.dims, n_heads, split.size):
            n_heads //= split.size
            same = kv_src is x
            x = split.copy(x)
            kv_src = x if same else split.copy(kv_src)
        else:
            params, split = split.whole(params), None
    q = (x @ params["wq"]).reshape(B, S, n_heads, head_dim)
    if precomputed_kv is None:
        T = kv_src.shape[1]
        k = (kv_src @ params["wk"]).reshape(B, T, n_heads, head_dim)
        v = (kv_src @ params["wv"]).reshape(B, T, n_heads, head_dim)
    else:
        k, v = precomputed_kv
    out = attention_core(q, k, v, mask)
    out = out.reshape(B, S, n_heads * head_dim) @ params["wo"]
    return (out if split is None else split.reduce(out)), (k, v)
