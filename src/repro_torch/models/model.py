"""Config-driven decoder for the dense GQA family — the counterpart of
``repro.models.model`` for ``mixer="gqa"`` and ``ffn="dense"``.

The parameter tree is the reference's: a dict with a leading layer axis
on every leaf of ``params["layers"]``, the same keys.  The forward pass
loops over the layers in Python (the reference scans; ``remat`` has no
effect on a forward pass).  With ``attn_impl="flash"`` and no sliding
window every layer runs the flash-attention kernel and no (S, S) mask is
built.  Other mixers, MoE, frontends and the encoder-decoder raise and
name the slice of the port that brings them.

Public API:
  init_params(generator, cfg, device)    -> params
  forward(params, cfg, batch)            -> (logits, aux_loss)
  hidden(params, cfg, batch)             -> final-norm hidden states
  loss_fn(params, cfg, batch)            -> (loss, metrics)
  layer_kinds(cfg)                       -> per-layer static descriptors
  init_caches(cfg, batch, capacity)      -> decode cache list
  decode_step(params, cfg, caches, index, batch) -> (logits, caches)
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import blocks

__all__ = ["init_params", "forward", "hidden", "loss_fn", "layer_kinds",
           "init_caches", "decode_step", "param_count"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _check_ported(cfg: ArchConfig) -> None:
    if cfg.mixer != "gqa":
        raise NotImplementedError(
            f"mixer {cfg.mixer!r} is not ported yet: MLA comes with the MoE "
            "slice, Mamba and hybrid with the Mamba slice")
    if cfg.ffn != "dense" or cfg.first_dense_layers:
        raise NotImplementedError(
            f"ffn {cfg.ffn!r} is not ported yet: it comes with the MoE slice")
    if cfg.is_encdec or cfg.frontend is not None:
        raise NotImplementedError(
            "encoder-decoder and frontend models are not ported yet: they "
            "come with the encoder-decoder and vision-frontend slices")


# ---------------------------------------------------------------------------
# layer pattern
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerKind:
    is_global: bool       # full attention (vs sliding window)
    ffn: str              # dense | moe | none


def layer_kinds(cfg: ArchConfig):
    """Static per-layer descriptors (drive cache layout and masks)."""
    kinds = []
    for i in range(cfg.n_layers):
        if cfg.global_pattern == "every_k":
            is_global = (i % cfg.global_every) == (cfg.global_every - 1)
        elif cfg.global_pattern == "hymba":
            is_global = i in (0, cfg.n_layers // 2, cfg.n_layers - 1)
        else:
            is_global = True
        ffn = cfg.ffn if i >= cfg.first_dense_layers else "dense"
        kinds.append(LayerKind(is_global=is_global, ffn=ffn))
    return kinds


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def _init_layer(generator, cfg: ArchConfig, dtype, device) -> dict:
    return {
        "ln1": blocks.init_rmsnorm(cfg.d_model, dtype, device),
        "attn": attn.init_gqa(generator, cfg.d_model, cfg.n_heads,
                              cfg.n_kv_heads, cfg.hd, dtype, device=device,
                              qk_norm=cfg.qk_norm, layout=cfg.attn_layout),
        "ffn": blocks.init_mlp(generator, cfg.d_model, cfg.d_ff, dtype,
                               device=device, fused=cfg.mlp_fused),
        "ln2": blocks.init_rmsnorm(cfg.d_model, dtype, device),
    }


def _stack(trees: list) -> dict:
    if isinstance(trees[0], dict):
        return {key: _stack([t[key] for t in trees]) for key in trees[0]}
    return torch.stack(trees)


def init_params(generator, cfg: ArchConfig, device=None) -> dict:
    """Random parameters drawn from ``generator``, a ``torch.Generator``
    on ``device`` (None on the ``meta`` device, where only shapes exist).
    ``device`` is CUDA unless the caller names another; a generator on
    another device raises."""
    _check_ported(cfg)
    device = resolve_device(device)
    if generator is not None and generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, parameters on "
                         f"{device}: make the generator on the parameters' "
                         "device")
    dtype = _DTYPES[cfg.param_dtype]
    return {
        "embed": blocks.init_embedding(generator, cfg.vocab_size,
                                       cfg.d_model, dtype, device=device),
        "final_norm": blocks.init_rmsnorm(cfg.d_model, dtype, device),
        "layers": _stack([_init_layer(generator, cfg, dtype, device)
                          for _ in range(cfg.n_layers)]),
    }


def param_count(params) -> int:
    return sum(leaf.numel() for leaf in tree_leaves(params))


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------

def _attn_impl_train(cfg: ArchConfig) -> str:
    """The flash kernel takes a static causal/window mask, so it serves
    only when every layer is plain causal (``sliding_window is None``);
    ``attn_impl="dense"`` (the default) keeps the dense softmax."""
    if cfg.attn_impl == "flash" and cfg.sliding_window is None:
        return "flash"
    return "dense"


def _layer(stacked: dict, i: int) -> dict:
    return {key: _layer(val, i) if isinstance(val, dict) else val[i]
            for key, val in stacked.items()}


def _apply_ffn(cfg: ArchConfig, lp: dict, x):
    h = blocks.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + blocks.mlp(lp["ffn"], h, cfg.activation)


def hidden(params, cfg: ArchConfig, batch):
    """The decoder stack up to the final norm: (B, S, d_model) in the
    compute dtype.  ``forward`` unembeds all of it; the prefill step only
    its last position."""
    _check_ported(cfg)
    tokens = batch["tokens"]
    cdt = _DTYPES[cfg.compute_dtype]
    x = blocks.embed(params["embed"], tokens).to(cdt)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    impl = _attn_impl_train(cfg)
    global_mask = local_mask = None        # flash builds no mask
    if impl == "dense":
        global_mask = local_mask = attn.causal_mask(S, S, device=x.device)
        if cfg.sliding_window is not None:
            local_mask = attn.causal_mask(S, S, cfg.sliding_window,
                                          device=x.device)
    for i, kind in enumerate(layer_kinds(cfg)):
        lp = _layer(params["layers"], i)
        h = blocks.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        out, _ = attn.gqa_attention(
            lp["attn"], h, positions, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, head_dim=cfg.hd, theta=cfg.rope_theta,
            qk_norm=cfg.qk_norm, impl=impl,
            mask_override=global_mask if kind.is_global else local_mask)
        x = _apply_ffn(cfg, lp, x + out)
    return blocks.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def forward(params, cfg: ArchConfig, batch):
    """batch: {"tokens": (B, S)}.  Returns (logits (B, S, V) float32,
    aux_loss 0-d float32)."""
    x = hidden(params, cfg, batch)
    return (blocks.unembed(params["embed"], x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def loss_fn(params, cfg: ArchConfig, batch):
    """Next-token cross-entropy (+ the aux loss, zero for dense FFNs)."""
    logits, aux = forward(params, cfg, batch)
    tokens = batch["tokens"]
    loss = blocks.cross_entropy_loss(logits[:, :-1], tokens[:, 1:])
    total = loss + cfg.aux_loss_weight * aux
    return total, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------------------
# decode path (serve_step)
# ---------------------------------------------------------------------------

def init_caches(cfg: ArchConfig, batch: int, capacity: int, device=None):
    """One KV cache per layer.  Windowed layers get ring buffers of size
    min(window, capacity)."""
    _check_ported(cfg)
    device = resolve_device(device)
    dtype = _DTYPES[cfg.compute_dtype]
    caches = []
    for kind in layer_kinds(cfg):
        ring = (not kind.is_global) and cfg.sliding_window is not None
        cap = min(cfg.sliding_window, capacity) if ring else capacity
        caches.append(attn.init_kv_cache(batch, cap, cfg.n_kv_heads, cfg.hd,
                                         dtype, device))
    return caches


def decode_step(params, cfg: ArchConfig, caches, index, batch):
    """One-token serve step.  batch: {"tokens": (B, 1)}; ``index`` is the
    current position (the caches' fill level).  Returns (logits
    (B, 1, V), caches) — the caches are updated in place."""
    _check_ported(cfg)
    index = int(index)
    tokens = batch["tokens"]
    x = blocks.embed(params["embed"], tokens).to(_DTYPES[cfg.compute_dtype])
    pos = torch.full(tokens.shape, index, dtype=torch.int64,
                     device=tokens.device)
    for i, kind in enumerate(layer_kinds(cfg)):
        lp = _layer(params["layers"], i)
        h = blocks.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        out, caches[i] = attn.gqa_attention(
            lp["attn"], h, pos, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.hd, theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
            cache=caches[i], cache_index=index,
            ring=(not kind.is_global) and cfg.sliding_window is not None)
        x = _apply_ffn(cfg, lp, x + out)
    x = blocks.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return blocks.unembed(params["embed"], x), caches
