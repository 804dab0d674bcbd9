"""Config-driven decoder for the dense GQA, MoE, MLA, Mamba and hybrid
families, the vision prefix and the whisper-style encoder-decoder — the
counterpart of ``repro.models.model`` for ``mixer`` in {"gqa", "mla",
"mamba", "hybrid"} and ``ffn`` in {"dense", "moe", "none"}.

The parameter tree is the reference's: a dict with a leading layer axis
on every leaf of ``params["layers"]``, the same keys; a config with
``first_dense_layers`` keeps those layers (dense FFN) in a stack of their
own, ``params["dense_layers"]``, which runs first.  The forward pass
loops over the layers in Python (the reference scans), each layer's
weights one ``unbind`` of the stacked leaves (its backward stacks the
layer gradients once; a per-layer ``select`` would build a zero tensor
of the whole leaf for every layer).  A caller may pass a stacked leaf
as a tuple of its layers' tensors instead (``layer_stacks`` names the
stacks): each layer's gradient then reaches its own leaf as soon as that
layer's backward is done, where the ``unbind``'s backward would run only
after every layer's.  When a backward will follow
(autograd on, some parameter requiring grad) and ``cfg.remat`` is set,
each layer body runs under ``torch.utils.checkpoint``: its activations
are recomputed in the backward, as the reference's ``jax.checkpoint`` of
the layer scan does (``remat_policy="dots"`` keeps the matrix products'
outputs and recomputes the rest, as its ``dots_saveable`` policy).  With ``attn_impl="flash"`` and no sliding
window every attention layer runs the flash-attention kernel and no
(S, S) mask is built; every Mamba layer's scan runs the selective-scan
kernel on the card (``models/mamba.py``).  MoE layers return the router's
aux loss, summed over the layers in the reference's order (the dense
stack first) into ``loss_fn``'s ``ce + aux_loss_weight * aux``.

A vision config (``frontend="vision"``) takes ``batch["patches"]``
(B, P, d_model) in front of the token embeddings: positions and the
causal mask cover the concatenation, and ``loss_fn`` leaves the P patch
positions out.  The encoder-decoder (``is_encdec``) runs a bidirectional
encoder over ``batch["frames"]`` (B, F, d_model) plus sinusoidal
positions (``params["encoder"]``, ``params["encoder_norm"]``), then a
decoder whose layers each add a cross-attention over the encoder's
output (``params["cross"]``); its attention is dense, as the
reference's.  Its decode caches are {"self": KV cache, "cross_k",
"cross_v"} a layer; ``init_caches`` makes the cross caches zeros, as
the reference does, and nothing here fills them: a caller fills them
from ``encoder_forward`` (the reference's tests do the same).

Within :func:`model_shards` (the 2-D engine on a ``model`` axis,
``launch.steps.build_sharded_rollout_fn``) the parameters passed in are
this process's blocks.  With ``split`` (the engine's default) each
module runs its products on the blocks, Megatron's split (the MLP's
d_ff, attention's heads, MoE's experts, Mamba's d_inner, the table's
vocab: ``blocks``, ``attention``, ``moe``, ``mamba``), and makes whole
inside the layer body only the cut leaves whose cut does not fall on
whole heads, experts or channels (:func:`gathered_leaves`); ``forward``
then returns this process's vocab block of the logits and ``loss_fn``
the loss over the blocks.  With ``whole`` each layer's leaves are made
whole at the start of the layer body, inside the function that remat
checkpoints, so the recompute gathers them again and no op saves the
whole weights; the tied table is made whole at each of its points of
use (the embedding and the unembedding).

Public API:
  init_params(generator, cfg, device)    -> params
  forward(params, cfg, batch)            -> (logits, aux_loss)
  hidden(params, cfg, batch)             -> final-norm hidden states
  loss_fn(params, cfg, batch)            -> (loss, metrics)
  layer_kinds(cfg)                       -> per-layer static descriptors
  layer_stacks(cfg)                      -> the keys of the layer stacks
  init_caches(cfg, batch, capacity)      -> decode cache list (KV caches,
                                            MLA latent caches, Mamba caches,
                                            KV and Mamba a layer, or KV and
                                            cross caches a layer)
  encoder_forward(params, cfg, frames)   -> the encoder's output
  decode_step(params, cfg, caches, index, batch) -> (logits, caches)
  model_shards(whole=, split=)           -> the 2-D engine's scope
  gathered_leaves(cfg, dims, size)       -> the cut leaves the split
                                            still makes whole
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import blocks
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_lib

__all__ = ["init_params", "forward", "hidden", "loss_fn", "layer_kinds",
           "layer_stacks", "init_caches", "decode_step", "param_count",
           "encoder_forward", "model_shards", "gathered_leaves"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


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

def _init_mixer(generator, cfg: ArchConfig, dtype, device) -> dict:
    """gqa: attention; mla: latent attention; mamba: the Mamba mixer;
    hybrid: attention (without qk-norm, as the reference's) beside Mamba,
    each with an output norm."""
    if cfg.mixer == "mla":
        return {"attn": attn.init_mla(
            generator, cfg.d_model, cfg.n_heads, cfg.kv_lora_rank, dtype,
            device=device, nope_dim=cfg.mla_nope_dim,
            rope_dim=cfg.mla_rope_dim, v_dim=cfg.mla_v_dim)}
    p = {}
    if cfg.mixer != "mamba":
        p["attn"] = attn.init_gqa(
            generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            dtype, device=device, qk_norm=cfg.qk_norm and cfg.mixer == "gqa",
            layout=cfg.attn_layout)
    if cfg.mixer != "gqa":
        p["mixer" if cfg.mixer == "mamba" else "mamba"] = mb.init_mamba(
            generator, cfg.d_model, cfg.ssm_state, cfg.ssm_expand,
            cfg.ssm_conv, dtype=dtype, device=device)
    if cfg.mixer == "hybrid":
        p["norm_attn"] = blocks.init_rmsnorm(cfg.d_model, dtype, device)
        p["norm_mamba"] = blocks.init_rmsnorm(cfg.d_model, dtype, device)
    return p


def _init_ffn(generator, cfg: ArchConfig, kind: str, dtype, device) -> dict:
    if kind == "dense":
        return {"ffn": blocks.init_mlp(generator, cfg.d_model, cfg.d_ff,
                                       dtype, device=device,
                                       fused=cfg.mlp_fused),
                "ln2": blocks.init_rmsnorm(cfg.d_model, dtype, device)}
    if kind == "moe":
        return {"ffn": moe_lib.init_moe(generator, cfg.d_model,
                                        cfg.n_experts, cfg.n_shared_experts,
                                        cfg.moe_d_ff, dtype, device=device),
                "ln2": blocks.init_rmsnorm(cfg.d_model, dtype, device)}
    return {}  # none (Mamba blocks carry their own gated expansion)


def _init_layer(generator, cfg: ArchConfig, kind: LayerKind, dtype,
                device) -> dict:
    p = {"ln1": blocks.init_rmsnorm(cfg.d_model, dtype, device)}
    p.update(_init_mixer(generator, cfg, dtype, device))
    p.update(_init_ffn(generator, cfg, kind.ffn, dtype, device))
    return p


def _stack(trees: list) -> dict:
    if isinstance(trees[0], dict):
        return {key: _stack([t[key] for t in trees]) for key in trees[0]}
    return torch.stack(trees)


def init_params(generator, cfg: ArchConfig, device=None) -> dict:
    """Random parameters drawn from ``generator``, a ``torch.Generator``
    on ``device`` (None on the ``meta`` device, where only shapes exist).
    ``device`` is CUDA unless the caller names another; a generator on
    another device raises."""
    device = resolve_device(device)
    if generator is not None and generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, parameters on "
                         f"{device}: make the generator on the parameters' "
                         "device")
    dtype = _DTYPES[cfg.param_dtype]
    params = {
        "embed": blocks.init_embedding(generator, cfg.vocab_size,
                                       cfg.d_model, dtype, device=device),
        "final_norm": blocks.init_rmsnorm(cfg.d_model, dtype, device),
    }
    for group, kinds in _groups(cfg):
        params[group] = _stack([_init_layer(generator, cfg, kind, dtype,
                                            device) for kind in kinds])
    if cfg.is_encdec:
        params.update(_init_encdec_extra(generator, cfg, dtype, device))
    return params


def _init_encdec_extra(generator, cfg: ArchConfig, dtype, device) -> dict:
    """Whisper: the decoder layers' cross-attention, the encoder's layer
    stack and its final norm."""
    def mha():
        return attn.init_mha(generator, cfg.d_model, cfg.n_heads, cfg.hd,
                             dtype, device=device)

    def norm():
        return blocks.init_rmsnorm(cfg.d_model, dtype, device)

    cross = [{"ln_cross": norm(), "attn": mha()}
             for _ in range(cfg.n_layers)]
    encoder = [{"ln1": norm(), "attn": mha(), "ln2": norm(),
                "ffn": blocks.init_mlp(generator, cfg.d_model, cfg.d_ff,
                                       dtype, device=device)}
               for _ in range(cfg.encoder_layers)]
    return {"cross": _stack(cross), "encoder": _stack(encoder),
            "encoder_norm": norm()}


def _groups(cfg: ArchConfig) -> list:
    """[(stack name, its layers' kinds)] in the order they run: the
    ``first_dense_layers`` in "dense_layers" (when there are any), the
    rest in "layers"."""
    kinds, n_dense = layer_kinds(cfg), cfg.first_dense_layers
    return ([("dense_layers", kinds[:n_dense])] if n_dense else []) \
        + [("layers", kinds[n_dense:])]


def layer_stacks(cfg: ArchConfig) -> tuple:
    """The top-level keys of the parameter tree whose leaves stack the
    layers on their first axis."""
    return tuple(g for g, _ in _groups(cfg)) \
        + (("encoder", "cross") if cfg.is_encdec else ())


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


def _layers(stacked: dict, n: int) -> list:
    """The n per-layer parameter dicts, one ``unbind`` per stacked leaf (a
    leaf given as a tuple of its layers is taken as it is)."""
    parts = {key: _layers(val, n) if isinstance(val, dict)
             else tuple(val) if isinstance(val, (list, tuple))
             else val.unbind(0) for key, val in stacked.items()}
    return [{key: part[i] for key, part in parts.items()} for i in range(n)]


#: set by :func:`model_shards`: ``whole(key, tree)`` and ``split(key)``,
#: or None.  Module globals, not ContextVars: the backward's recompute
#: runs on autograd's own thread on the card, and must gather there too
_WHOLE = None
_SPLIT = None


@contextlib.contextmanager
def model_shards(whole=None, split=None):
    """Within the block the parameters are this process's blocks.

    ``split(key)`` gives the :class:`repro_torch.core.collective.
    ModelSplit` of a top-level key of the parameter tree (one layer's
    dims for a layer stack, ``layer_stacks``; the table's for "embed"):
    the modules run their products on the blocks.  Or ``whole(key,
    tree)`` makes each leaf of ``tree`` (a key's subtree of blocks, one
    layer's dict for a layer stack) whole: a layer's call runs inside
    the layer body (and again in its recompute under remat), the table's
    at the embedding and at the unembedding."""
    global _WHOLE, _SPLIT
    before, (_WHOLE, _SPLIT) = (_WHOLE, _SPLIT), (whole, split)
    try:
        yield
    finally:
        _WHOLE, _SPLIT = before


def _whole(key: str, tree):
    return tree if _WHOLE is None else _WHOLE(key, tree)


def _split(key: str):
    return None if _SPLIT is None else _SPLIT(key)


def _sub(split, name: str):
    return None if split is None else split.sub(name)


def gathered_leaves(cfg: ArchConfig, dims: dict, size: int) -> dict:
    """The leaves of a one-model tree whose dims (``dims``: the
    parameter tree with each leaf's cut dim on the model axis, None where
    whole; a layer stack's without its layer axis) the split on ``size``
    model shards still makes whole inside the layer: True where a leaf is
    cut but its product does not run on blocks (the rules of
    ``blocks.mlp_splits``, ``attention.heads_split`` / ``kv_split``,
    ``mamba.channels_split``, ``moe.experts_split`` / ``shared_split``);
    the table never is (a vocab block, or whole on every process)."""
    def cut(tree, names=None):
        return {k: cut(v, names) if isinstance(v, dict) else
                v is not None and (names is None or k in names)
                for k, v in tree.items()}

    def attention(d, mha=False):
        if not attn.heads_split(d, cfg.n_heads, size) or (
                not mha and cfg.mixer != "mla"
                and cfg.attn_layout != "fused"):
            return cut(d)
        if mha or cfg.mixer == "mla" \
                or attn.kv_split(d, cfg.n_kv_heads, size):
            return cut(d, ())
        return cut(d, ("wk", "wv"))

    def layer(d, kind, mha):
        out = cut(d, ())
        for name, sub in d.items():
            if name == "attn":
                out[name] = attention(sub, mha)
            elif name in ("mixer", "mamba"):
                out[name] = cut(sub, () if mb.channels_split(sub) else None)
            elif name == "ffn" and kind == "moe":
                names = () if moe_lib.experts_split(sub, cfg.moe_impl) \
                    else ("w_gate", "w_up", "w_down")
                if not moe_lib.shared_split(sub):
                    names += ("shared_gate", "shared_up", "shared_down")
                out[name] = cut(sub, names)
            elif name == "ffn":
                out[name] = cut(sub, () if blocks.mlp_splits(sub) else None)
        return out

    kinds = dict(_groups(cfg))
    out = {}
    for key, d in dims.items():
        if key in kinds:
            out[key] = layer(d, kinds[key][0].ffn, cfg.is_encdec)
        elif key in ("encoder", "cross"):
            out[key] = layer(d, "dense", True)
        else:
            out[key] = cut(d, ())
    return out


def _remat(cfg: ArchConfig, params):
    """The layers' checkpoint policy when a backward follows (autograd
    on, some parameter requiring grad) and ``cfg.remat`` asks for one:
    "dots" keeps the matrix products' outputs (the reference's
    ``dots_saveable``), anything else recomputes the whole layer; None
    runs the layers plainly."""
    if not (cfg.remat and torch.is_grad_enabled()
            and any(a.requires_grad for a in tree_leaves(params))):
        return None
    return "dots" if cfg.remat_policy == "dots" else "full"


def _attention(cfg: ArchConfig, p: dict, x, positions, **kw):
    """The GQA half of a gqa or hybrid layer (the reference's hybrid
    attention takes no qk-norm)."""
    return attn.gqa_attention(
        p, x, positions, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.hd, theta=cfg.rope_theta,
        qk_norm=cfg.qk_norm and cfg.mixer == "gqa", **kw)


def _fuse(lp: dict, a, m):
    """The hybrid's mean of the normalized attention and Mamba outputs."""
    return 0.5 * (blocks.rmsnorm(lp["norm_attn"], a)
                  + blocks.rmsnorm(lp["norm_mamba"], m))


def _mla(cfg: ArchConfig, p: dict, x, positions, **kw):
    return attn.mla_attention(
        p, x, positions, n_heads=cfg.n_heads, kv_lora=cfg.kv_lora_rank,
        theta=cfg.rope_theta, nope_dim=cfg.mla_nope_dim,
        rope_dim=cfg.mla_rope_dim, v_dim=cfg.mla_v_dim, **kw)


def _apply_mixer(cfg: ArchConfig, lp: dict, x, positions, mask, impl,
                 split=None):
    """The full-sequence mixer of one layer (the reference's
    ``_apply_mixer_train``); ``split``: the layer's on a model axis."""
    if cfg.mixer == "mla":
        return _mla(cfg, lp["attn"], x, positions,
                    split=_sub(split, "attn"))[0]
    if cfg.mixer == "mamba":
        return mb.mamba_forward(lp["mixer"], x, d_state=cfg.ssm_state,
                                chunk=cfg.scan_chunk,
                                split=_sub(split, "mixer"))
    a, _ = _attention(cfg, lp["attn"], x, positions, impl=impl,
                      mask_override=mask, split=_sub(split, "attn"))
    if cfg.mixer == "gqa":
        return a
    return _fuse(lp, a, mb.mamba_forward(lp["mamba"], x,
                                         d_state=cfg.ssm_state,
                                         chunk=cfg.scan_chunk,
                                         split=_sub(split, "mamba")))


def _apply_ffn(cfg: ArchConfig, lp: dict, x, kind: str, with_aux=True,
               split=None):
    """(x + ffn(x), the layer's aux loss: a 0-d float32 for MoE when
    ``with_aux``, else None); ``split``: the layer's on a model axis."""
    if kind == "none":
        return x, None
    h = blocks.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    if kind == "dense":
        return x + blocks.mlp(lp["ffn"], h, cfg.activation,
                              split=_sub(split, "ffn")), None
    y, aux = moe_lib.moe_ffn(
        lp["ffn"], h, n_experts=cfg.n_experts, k=cfg.experts_per_token,
        capacity_factor=cfg.capacity_factor, impl=cfg.moe_impl,
        n_shared=cfg.n_shared_experts, with_aux=with_aux,
        split=_sub(split, "ffn"))
    return x + y, aux


def _add(total, part):
    """total + part where None stands for zero (adding the reference's
    zeros changes no bit)."""
    return part if total is None else total if part is None else total + part


def _decoder_layer(cfg: ArchConfig, kind: LayerKind, lp: dict, x, positions,
                   mask, impl, stack: str):
    lp, split = _whole(stack, lp), _split(stack)
    h = blocks.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    x = x + _apply_mixer(cfg, lp, h, positions, mask, impl, split)
    return _apply_ffn(cfg, lp, x, kind.ffn, split=split)


def hidden(params, cfg: ArchConfig, batch):
    """The decoder stack up to the final norm: (B, S, d_model) in the
    compute dtype (S counts the patches of a vision batch).  ``forward``
    unembeds all of it; the prefill step only its last position."""
    return _hidden_aux(params, cfg, batch)[0]


#: the ops whose outputs ``remat_policy="dots"`` keeps: the matrix
#: products (``linear``, ``matmul`` and ``einsum`` reach these)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _run(layer, remat, *args):
    """``layer(*args)``, under ``torch.utils.checkpoint`` when ``remat``:
    "full" recomputes the layer in the backward, "dots" recomputes all
    but the matrix products, whose outputs it keeps (selective
    checkpointing); both give the same bits as no remat."""
    if remat == "dots":
        from torch.utils.checkpoint import \
            create_selective_checkpoint_contexts
        return checkpoint(layer, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _dots_policy))
    if remat:
        return checkpoint(layer, *args, use_reentrant=False)
    return layer(*args)


def _encoder_layer(cfg: ArchConfig, lp: dict, h):
    lp, split = _whole("encoder", lp), _split("encoder")
    # the reference normalizes ln1 twice from one input: once is the same
    x = blocks.rmsnorm(lp["ln1"], h, cfg.norm_eps)
    h = h + attn.mha_attention(lp["attn"], x, x, n_heads=cfg.n_heads,
                               head_dim=cfg.hd,
                               split=_sub(split, "attn"))[0]
    return _apply_ffn(cfg, lp, h, "dense", split=split)[0]


def encoder_forward(params, cfg: ArchConfig, frames):
    """The encoder over frames (B, F, d_model) plus sinusoidal
    positions, bidirectional: (B, F, d_model) after its final norm, in
    the compute dtype."""
    x = frames.to(_DTYPES[cfg.compute_dtype])
    x = x + blocks.sinusoidal_positions(frames.shape[1], cfg.d_model,
                                        x.device)[None].to(x.dtype)
    remat = _remat(cfg, params)
    for lp in _layers(params["encoder"], cfg.encoder_layers):
        x = _run(_encoder_layer, remat, cfg, lp, x)
    return blocks.rmsnorm(params["encoder_norm"], x, cfg.norm_eps)


def _encdec_layer(cfg: ArchConfig, lp: dict, cp: dict, h, enc_out, mask):
    """A decoder layer: masked self-attention, cross-attention over the
    encoder's output, the MLP."""
    lp, cp = _whole("layers", lp), _whole("cross", cp)
    split, cross = _split("layers"), _split("cross")
    x = blocks.rmsnorm(lp["ln1"], h, cfg.norm_eps)
    h = h + attn.mha_attention(lp["attn"], x, x, n_heads=cfg.n_heads,
                               head_dim=cfg.hd, mask=mask,
                               split=_sub(split, "attn"))[0]
    x = blocks.rmsnorm(cp["ln_cross"], h, cfg.norm_eps)
    h = h + attn.mha_attention(cp["attn"], x, enc_out, n_heads=cfg.n_heads,
                               head_dim=cfg.hd,
                               split=_sub(cross, "attn"))[0]
    return _apply_ffn(cfg, lp, h, "dense", split=split)[0]


def _encdec_hidden(params, cfg: ArchConfig, batch):
    enc_out = encoder_forward(params, cfg, batch["frames"])
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = blocks.embed(_whole("embed", params["embed"]), tokens,
                     split=_split("embed")).to(_DTYPES[cfg.compute_dtype])
    x = x + blocks.sinusoidal_positions(S, cfg.d_model,
                                        x.device)[None].to(x.dtype)
    mask = attn.causal_mask(S, S, device=x.device)
    remat = _remat(cfg, params)
    for lp, cp in zip(_layers(params["layers"], cfg.n_layers),
                      _layers(params["cross"], cfg.n_layers)):
        x = _run(_encdec_layer, remat, cfg, lp, cp, x, enc_out, mask)
    return blocks.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def _hidden_aux(params, cfg: ArchConfig, batch):
    """(``hidden``, the aux loss summed over the layers: each stack's
    layers from zero in order, then the stacks' sums in order, as the
    reference's scans carry it; None without MoE)."""
    if cfg.is_encdec:
        return _encdec_hidden(params, cfg, batch), None
    tokens = batch["tokens"]
    cdt = _DTYPES[cfg.compute_dtype]
    x = blocks.embed(_whole("embed", params["embed"]), tokens,
                     split=_split("embed")).to(cdt)
    if cfg.frontend == "vision" and "patches" in batch:
        x = torch.cat([batch["patches"].to(cdt), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    impl = _attn_impl_train(cfg)
    global_mask = local_mask = None     # flash, MLA, Mamba: no mask here
    if impl == "dense" and cfg.mixer in ("gqa", "hybrid"):
        global_mask = local_mask = attn.causal_mask(S, S, device=x.device)
        if cfg.sliding_window is not None:
            local_mask = attn.causal_mask(S, S, cfg.sliding_window,
                                          device=x.device)
    remat = _remat(cfg, params)
    aux = None
    for group, kinds in _groups(cfg):
        group_aux = None
        for lp, kind in zip(_layers(params[group], len(kinds)), kinds):
            mask = global_mask if kind.is_global else local_mask
            x, layer_aux = _run(_decoder_layer, remat, cfg, kind, lp, x,
                                positions, mask, impl, group)
            group_aux = _add(group_aux, layer_aux)
        aux = _add(aux, group_aux)
    return blocks.rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def forward(params, cfg: ArchConfig, batch):
    """batch: {"tokens": (B, S)} plus {"patches": (B, P, d_model)} for a
    vision config (logits (B, P + S, V)) or {"frames": (B, F, d_model)}
    for the encoder-decoder.  Returns (logits float32, aux_loss 0-d
    float32); within :func:`model_shards`'s split of a table cut on its
    vocab rows, the logits are this process's vocab block."""
    x, aux = _hidden_aux(params, cfg, batch)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return blocks.unembed(_whole("embed", params["embed"]), x,
                          split=_split("embed")), aux


def loss_fn(params, cfg: ArchConfig, batch):
    """Next-token cross-entropy + ``aux_loss_weight`` x the MoE aux loss
    (zero without MoE).  The patch positions of a vision batch are left
    out."""
    logits, aux = forward(params, cfg, batch)
    tokens = batch["tokens"]
    if cfg.frontend == "vision" and "patches" in batch:
        logits = logits[:, batch["patches"].shape[1]:]
    loss = blocks.cross_entropy_loss(logits[:, :-1], tokens[:, 1:],
                                     split=_split("embed"))
    total = loss + cfg.aux_loss_weight * aux
    return total, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------------------
# decode path (serve_step)
# ---------------------------------------------------------------------------

def init_caches(cfg: ArchConfig, batch: int, capacity: int, device=None):
    """One cache per layer: a KV cache (gqa), an ``MLACache`` of the
    latent (mla), a ``MambaCache`` (mamba), or {"attn": KV cache,
    "mamba": MambaCache} (hybrid).  Windowed layers get ring buffers of
    size min(window, capacity).  The encoder-decoder's is {"self": KV
    cache, "cross_k": zeros, "cross_v": zeros}, the cross caches
    (B, n_frontend_tokens, H, D) for the caller to fill."""
    device = resolve_device(device)
    dtype = _DTYPES[cfg.compute_dtype]
    caches = []
    for kind in layer_kinds(cfg):
        ring = (not kind.is_global) and cfg.sliding_window is not None
        cap = min(cfg.sliding_window, capacity) if ring else capacity
        if cfg.mixer == "gqa":
            caches.append(attn.init_kv_cache(batch, cap, cfg.n_kv_heads,
                                             cfg.hd, dtype, device))
        elif cfg.mixer == "mla":
            caches.append(attn.init_mla_cache(batch, capacity,
                                              cfg.kv_lora_rank,
                                              cfg.mla_rope_dim, dtype,
                                              device))
        elif cfg.mixer == "mamba":
            caches.append(mb.init_mamba_cache(batch, cfg.d_inner,
                                              cfg.ssm_state, cfg.ssm_conv,
                                              dtype, device))
        else:
            caches.append({
                "attn": attn.init_kv_cache(batch, cap, cfg.n_kv_heads,
                                           cfg.hd, dtype, device),
                "mamba": mb.init_mamba_cache(batch, cfg.d_inner,
                                             cfg.ssm_state, cfg.ssm_conv,
                                             dtype, device)})
        if cfg.is_encdec:
            shape = (batch, cfg.n_frontend_tokens, cfg.n_heads, cfg.hd)
            caches[-1] = {
                "self": caches[-1],
                "cross_k": torch.zeros(shape, dtype=dtype, device=device),
                "cross_v": torch.zeros(shape, dtype=dtype, device=device)}
    return caches


def _decode_mixer(cfg: ArchConfig, lp: dict, cache, x, pos, index: int,
                  kind: LayerKind):
    if cfg.mixer == "mla":
        return _mla(cfg, lp["attn"], x, pos, cache=cache, cache_index=index)
    if cfg.mixer == "mamba":
        return mb.mamba_decode_step(lp["mixer"], x, cache,
                                    d_state=cfg.ssm_state)
    ring = (not kind.is_global) and cfg.sliding_window is not None
    kv = cache if cfg.mixer == "gqa" else cache["attn"]
    a, kv = _attention(cfg, lp["attn"], x, pos, cache=kv, cache_index=index,
                       ring=ring)
    if cfg.mixer == "gqa":
        return a, kv
    m, ssm = mb.mamba_decode_step(lp["mamba"], x, cache["mamba"],
                                  d_state=cfg.ssm_state)
    return _fuse(lp, a, m), {"attn": kv, "mamba": ssm}


def decode_step(params, cfg: ArchConfig, caches, index, batch):
    """One-token serve step.  batch: {"tokens": (B, 1)}; ``index`` is the
    current position (the caches' fill level).  Returns (logits
    (B, 1, V), caches) — the caches are updated in place."""
    index = int(index)
    tokens = batch["tokens"]
    x = blocks.embed(params["embed"], tokens).to(_DTYPES[cfg.compute_dtype])
    if cfg.is_encdec:
        return _encdec_decode(params, cfg, caches, index, x)
    pos = torch.full(tokens.shape, index, dtype=torch.int64,
                     device=tokens.device)
    layers = [lp for group, kinds in _groups(cfg)
              for lp in _layers(params[group], len(kinds))]
    for i, (lp, kind) in enumerate(zip(layers, layer_kinds(cfg))):
        h = blocks.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        out, caches[i] = _decode_mixer(cfg, lp, caches[i], h, pos, index,
                                       kind)
        x = _apply_ffn(cfg, lp, x + out, kind.ffn, with_aux=False)[0]
    x = blocks.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return blocks.unembed(params["embed"], x), caches


def _encdec_decode(params, cfg: ArchConfig, caches, index: int, x):
    """The encoder-decoder's decode step from the token embeddings x
    (B, 1, d_model): the sinusoidal row at ``index``, then each layer's
    self-attention on its linear KV cache, cross-attention on its cross
    caches, the MLP."""
    x = x + blocks.sinusoidal_position_at(index, cfg.d_model,
                                          x.device).to(x.dtype)
    for cache, lp, cp in zip(caches, _layers(params["layers"], cfg.n_layers),
                             _layers(params["cross"], cfg.n_layers)):
        h = blocks.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        x = x + _decode_mixer_mha(cfg, lp["attn"], cache["self"], h, index)
        h = blocks.rmsnorm(cp["ln_cross"], x, cfg.norm_eps)
        x = x + attn.mha_attention(
            cp["attn"], h, h, n_heads=cfg.n_heads, head_dim=cfg.hd,
            precomputed_kv=(cache["cross_k"], cache["cross_v"]))[0]
        x = _apply_ffn(cfg, lp, x, "dense")[0]
    x = blocks.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return blocks.unembed(params["embed"], x), caches


def _decode_mixer_mha(cfg: ArchConfig, p: dict, cache, x, index: int):
    """The encoder-decoder's self-attention decode: no RoPE, the new key
    and value written in place at ``index`` of a linear cache."""
    B, H, D = x.shape[0], cfg.n_heads, cfg.hd
    k = (x @ p["wk"]).reshape(B, 1, H, D)
    v = (x @ p["wv"]).reshape(B, 1, H, D)
    attn._write_cache(cache, (k, v), index)
    q = (x @ p["wq"]).reshape(B, 1, H, D)
    valid = torch.arange(cache.k.shape[1], device=x.device) <= index
    out = attn.attention_core(q, cache.k, cache.v, valid[None, None, None])
    return out.reshape(B, 1, H * D) @ p["wo"]
