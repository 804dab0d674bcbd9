"""Flat-buffer compression engine — the counterpart of
``repro.core.flatbuf`` for the QSGD and natural codecs.

The whole parameter tree is raveled into ONE contiguous float32 buffer
with static leaf offsets (:class:`FlatLayout`), bucketized once and
compressed by a single kernel launch with in-kernel counter noise
(DESIGN.md §2).  Every function here also takes a tree whose leaves carry
a leading client axis — the reference's ``vmap`` over clients written
out as a batch dimension: the layout describes ONE model, and the
raveled buffer is (n, d).

  layout_of / ravel / unravel   — tree <-> flat buffer, static offsets
  bucketize / unbucketize       — the one pad/bucket/reshape rule
  seeds_of                      — key words -> the kernels' two seed words
  flat_tree_apply               — fused whole-tree C(x) (flat transport)
  pack_tree / unpack_tree       — whole-tree wire payloads (QSGDPayload,
                                  NaturalPayload), bit-exact against
                                  flat_tree_apply; unpack_tree_qsgd also
                                  takes a hand-built QSGD payload
  payload_wire_bits / packed_wire_bits
                                — exact wire sizes
  pack_tree_qsgd / pack_tree_natural
                                — codec-specific encoders
  narrow_tree_qsgd / widen_tree_qsgd
                                — the sub-byte QSGD wire and its inverse
  payload_spec                  — a payload of meta tensors (round_bits)
  payload_finite_mask / sanitize_payload / reduce_payload_acc /
  reduce_payload_mean           — the server's one-pass masked mean of a
                                  stacked payload batch, O(d) state
                                  (DESIGN.md §10)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.codec import (NarrowQSGDPayload, NaturalPayload,
                                    QSGDPayload, spec_tensor)
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.kernels.bits import natural_merge, pack_bits, unpack_bits
from repro_torch.kernels.natural.kernel import natural_fused, natural_pack
from repro_torch.kernels.natural.ops import natural_reduce
from repro_torch.kernels.qsgd.kernel import (check_levels, qsgd_fused,
                                             qsgd_pack, qsgd_unpack)
from repro_torch.kernels.qsgd.ops import qsgd_reduce

__all__ = [
    "FlatLayout", "layout_of", "ravel", "unravel", "bucketize",
    "unbucketize", "seeds_of", "supports_flat", "supports_fused_reduce",
    "flat_tree_apply", "pack_tree", "pack_tree_qsgd", "pack_tree_natural",
    "unpack_tree", "unpack_tree_qsgd", "narrow_tree_qsgd", "widen_tree_qsgd",
    "payload_spec", "payload_finite_mask", "sanitize_payload",
    "reduce_payload_acc", "reduce_payload_mean", "payload_wire_bits",
    "packed_wire_bits",
]

_LANE = 128          # natural buckets; sub-bucket models pad to this
_GOLDEN = np.uint32(0x9E3779B9)


def supports_flat(comp) -> bool:
    """True for compressors with a flat-engine kernel."""
    return getattr(comp, "name", None) in ("qsgd", "natural")


# --------------------------------------------------------------------------
# layout: tree <-> flat buffer
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Static metadata of one raveled model: leaf shapes/dtypes and their
    offsets into the flat float32 buffer, plus the bucket geometry."""

    treedef: Any
    shapes: tuple
    dtypes: tuple
    offsets: tuple
    d: int
    bucket: int

    @property
    def n_buckets(self) -> int:
        return max(-(-self.d // self.bucket), 1)

    @property
    def padded(self) -> int:
        return self.n_buckets * self.bucket

    @property
    def pad(self) -> int:
        return self.padded - self.d


def _size(shape) -> int:
    return int(np.prod(shape)) if len(shape) else 1


def layout_of(tree, bucket: int = 2048, *, batch_dims: int = 0) -> FlatLayout:
    """Layout of one model; ``batch_dims`` leading axes of every leaf
    (the client axis of a stacked tree) are not part of the model."""
    leaves, treedef = tree_flatten(tree)
    shapes = tuple(tuple(leaf.shape)[batch_dims:] for leaf in leaves)
    dtypes = tuple(leaf.dtype for leaf in leaves)
    sizes = [_size(s) for s in shapes]
    offsets = tuple(int(o) for o in np.cumsum([0] + sizes[:-1]))
    return FlatLayout(treedef=treedef, shapes=shapes, dtypes=dtypes,
                      offsets=offsets, d=int(sum(sizes)), bucket=int(bucket))


def _batch_shape(layout: FlatLayout, leaves) -> tuple:
    leaf, shape = leaves[0], layout.shapes[0]
    return tuple(leaf.shape[:leaf.dim() - len(shape)])


def ravel(layout: FlatLayout, tree, *, device=None) -> torch.Tensor:
    """Concatenate all leaves into one (..., d) float32 buffer (``...`` is
    the batch shape).  A single-leaf tree is a reshape, not a copy.  A
    tree without leaves has no device of its own: its (0,) buffer goes
    to ``device`` (default: torch's default device)."""
    leaves = tree_flatten(tree)[0]
    if not leaves:
        return torch.zeros((0,), dtype=torch.float32, device=device)
    batch = _batch_shape(layout, leaves)
    flat = [leaf.reshape(batch + (-1,)).to(torch.float32) for leaf in leaves]
    if len(flat) == 1:
        return flat[0]
    return torch.cat(flat, dim=-1)


def unravel(layout: FlatLayout, flat: torch.Tensor):
    """Slice the (..., d) buffer back into the tree (views where the
    dtype is float32)."""
    batch = tuple(flat.shape[:-1])
    leaves = []
    for shape, dtype, off in zip(layout.shapes, layout.dtypes,
                                 layout.offsets):
        n = _size(shape)
        leaves.append(flat[..., off:off + n].reshape(batch + shape).to(dtype))
    return tree_unflatten(layout.treedef, leaves)


def bucketize(x: torch.Tensor, bucket: int) -> torch.Tensor:
    """Pad the last axis to a bucket multiple and view it (..., n_buckets,
    bucket) — the single pad/bucket/reshape rule of the engine."""
    d = x.shape[-1]
    batch = tuple(x.shape[:-1])
    if d == 0:
        return torch.zeros(batch + (1, bucket), dtype=x.dtype, device=x.device)
    pad = (-d) % bucket
    if pad:
        x = F.pad(x, (0, pad))
    return x.reshape(batch + (-1, bucket))


def unbucketize(x2d: torch.Tensor, d: int) -> torch.Tensor:
    batch = tuple(x2d.shape[:-2])
    return x2d.reshape(batch + (-1,))[..., :d]


def seeds_of(key) -> np.ndarray:
    """Fold key words (..., W) into the (..., 2) uint32 seed pair of the
    counter RNG, exactly as the reference does: XOR of the even words,
    XOR of the odd words (the first word when there is only one), the
    second lane XORed with the golden constant."""
    data = np.asarray(key, np.uint32)
    s0 = np.bitwise_xor.reduce(data[..., 0::2], axis=-1)
    odds = data[..., 1::2] if data.shape[-1] > 1 else data[..., :1]
    s1 = np.bitwise_xor.reduce(odds, axis=-1) ^ _GOLDEN
    return np.stack([s0, s1], axis=-1).astype(np.uint32)


# --------------------------------------------------------------------------
# fused whole-tree compression and the wire payload
# --------------------------------------------------------------------------

def _engine_bucket(comp) -> int:
    return int(getattr(comp, "bucket", None) or _LANE)


def _clamp_bucket(bucket: int, d: int) -> int:
    """A model smaller than one bucket is one bucket at any bucket size
    (one norm over all d values), so it pads only to the next lane
    multiple: a 124-element model costs 128 codes, not 2048."""
    if d and d < bucket:
        return max(-(-d // _LANE) * _LANE, _LANE)
    return bucket


def flat_tree_apply(comp, key, tree, *, bucket: int = None):
    """Compress one model's tree in ONE fused launch: ravel -> bucketize
    -> kernel -> unravel.  Bit-exact vs ``unpack_tree(pack_tree(...))``
    under the same key.  Keys (n, 2) compress a tree whose leaves carry
    a leading client axis n, one launch a client (the reference's
    ``vmap``: each client's buffer is raveled and keyed on its own)."""
    if not supports_flat(comp):
        raise ValueError(f"no flat engine for compressor {comp!r}")
    keys = np.asarray(key, np.uint32)
    if keys.ndim > 1:
        leaves, treedef = tree_flatten(tree)
        batch = keys.shape[:-1]
        rows = [flat_tree_apply(
            comp, k, tree_unflatten(treedef, [a.reshape((-1,) + tuple(
                a.shape[len(batch):]))[i] for a in leaves]), bucket=bucket)
            for i, k in enumerate(keys.reshape(-1, 2))]
        return tree_unflatten(treedef, [
            torch.stack(parts).reshape(tuple(a.shape))
            for parts, a in zip(zip(*(tree_flatten(r)[0] for r in rows)),
                                leaves)])
    bucket = int(bucket or _engine_bucket(comp))
    layout = layout_of(tree, bucket)
    if layout.d == 0:
        return tree
    bucket = _clamp_bucket(bucket, layout.d)
    layout = layout_of(tree, bucket)
    x2d = bucketize(ravel(layout, tree), bucket).contiguous()
    if comp.name == "qsgd":
        y2d = qsgd_fused(x2d, seeds_of(key), levels=comp.levels)
    else:
        y2d = natural_fused(x2d, seeds_of(key))
    return unravel(layout, unbucketize(y2d, layout.d))


def pack_tree(comp, key, tree, *, bucket: int = None):
    """Quantize a tree to its wire payload — the encode of the flat and
    packed transports.  ``key`` (2,) encodes one model; keys (n, 2)
    encode a stacked tree of n models (leading client axis)."""
    if not supports_flat(comp):
        raise ValueError(f"no flat engine for compressor {comp!r}")
    bucket = int(bucket or _engine_bucket(comp))
    if comp.name == "qsgd":
        return pack_tree_qsgd(key, tree, levels=comp.levels,
                              bucket=bucket)[0]
    return pack_tree_natural(key, tree, bucket=bucket)[0]


def _stacked_input(key, tree, bucket: int):
    """(seed words (..., 2), one-model layout at the clamped bucket, the
    bucketized (..., n_buckets, bucket) buffer, device) of the tree a key
    or a batch of keys encodes; the buffer is None for an empty model."""
    keys = np.asarray(key, np.uint32)
    batch_dims = keys.ndim - 1
    leaves = tree_flatten(tree)[0]
    device = leaves[0].device if leaves else torch.device("cpu")
    layout = layout_of(tree, bucket, batch_dims=batch_dims)
    if layout.d == 0:
        return keys, layout, None, device
    bucket = _clamp_bucket(bucket, layout.d)
    layout = layout_of(tree, bucket, batch_dims=batch_dims)
    x2d = bucketize(ravel(layout, tree), bucket).contiguous()
    return keys, layout, x2d, device


def pack_tree_qsgd(key, tree, *, levels: int = 127, bucket: int = 2048):
    """QSGD payload of one model (``key`` (2,)) or of a stacked tree
    (``key`` (n, 2)).  Returns (payload, one-model layout)."""
    check_levels(levels)
    keys, layout, x2d, device = _stacked_input(key, tree, bucket)
    if x2d is None:
        batch = keys.shape[:-1]
        payload = QSGDPayload(
            torch.zeros(batch + (0, bucket), dtype=torch.int8, device=device),
            torch.zeros(batch + (0, 1), dtype=torch.float32, device=device),
            levels=levels, layout=layout)
        return payload, layout
    codes, norms = qsgd_pack(x2d, seeds_of(keys), levels=levels)
    return QSGDPayload(codes, norms, levels=levels, layout=layout), layout


def pack_tree_natural(key, tree, *, bucket: int = _LANE):
    """Natural payload (uint8 exponent codes + packed sign bitmap, 9
    bits per element) of one model (``key`` (2,)) or of a stacked tree
    (``key`` (n, 2)), from ONE pack launch.  Returns (payload, one-model
    layout)."""
    keys, layout, x2d, device = _stacked_input(key, tree, bucket)
    if x2d is None:
        batch = keys.shape[:-1]
        payload = NaturalPayload(
            torch.zeros(batch + (0, bucket), dtype=torch.uint8, device=device),
            torch.zeros(batch + (0, bucket // 8), dtype=torch.uint8,
                        device=device), layout=layout)
        return payload, layout
    exps, signs = natural_pack(x2d, seeds_of(keys))
    return NaturalPayload(exps, signs, layout=layout), layout


def unpack_tree_qsgd(payload: QSGDPayload, layout: FlatLayout = None, *,
                     levels: int = 127):
    """Dequantize a QSGD payload back to the tree — bit-exact vs the
    output of :func:`flat_tree_apply` under the same key.  ``layout`` /
    ``levels`` are read only for hand-built payloads (2-D codes and
    norms); engine payloads carry their own."""
    if getattr(payload, "layout", None) is not None:
        return unpack_tree(payload)
    y2d = qsgd_unpack(payload.codes, payload.norms, levels=levels)
    return unravel(layout, unbucketize(y2d, layout.d))


def unpack_tree(payload):
    """Dequantize a flat-engine payload (one model, or a stacked batch)
    back to its tree — bit-exact vs :func:`flat_tree_apply` under the
    same key.  Natural payloads merge in plain PyTorch (the reference has
    no kernel for it either)."""
    if isinstance(payload, NarrowQSGDPayload):
        payload = widen_tree_qsgd(payload)
    layout = payload.layout
    if layout is None:
        raise ValueError("payload carries no FlatLayout; it was not "
                         "produced by the flat engine (pack_tree)")
    wire = _wire(payload)
    batch = tuple(wire.shape[:-2])
    if layout.d == 0:
        return unravel(layout, torch.zeros(batch + (0,), device=wire.device))
    if isinstance(payload, NaturalPayload):
        y = natural_merge(payload.exps, unpack_bits(payload.signs, 1))
        return unravel(layout, unbucketize(y, layout.d))
    codes = payload.codes
    b = codes.shape[-1]
    y2d = qsgd_unpack(codes.reshape(-1, b), payload.norms.reshape(-1, 1),
                      levels=payload.levels)
    return unravel(layout, unbucketize(y2d.reshape(codes.shape), layout.d))


def _wire(payload) -> torch.Tensor:
    """The per-element wire tensor of a flat-engine payload."""
    return payload.exps if isinstance(payload, NaturalPayload) \
        else payload.codes


def _narrow_width(levels: int) -> int:
    """Smallest field width holding sign + magnitude <= levels: 2 bits
    at levels 1, 4 bits at levels <= 7."""
    if levels <= 1:
        return 2
    if levels <= 7:
        return 4
    raise ValueError(
        f"levels={levels} has no sub-byte pack (magnitude needs "
        f"{max(int(np.ceil(np.log2(levels + 1))), 1)} bits + sign); use "
        "levels <= 7 or keep the int8 QSGDPayload")


def narrow_tree_qsgd(payload: QSGDPayload) -> NarrowQSGDPayload:
    """Repack a flat-engine QSGD payload with ``levels <= 7`` into
    ``width``-bit sign-magnitude fields, 8 / width per byte — lossless:
    :func:`widen_tree_qsgd` restores the int8 codes bit for bit."""
    width = _narrow_width(payload.levels)
    codes = payload.codes
    mag = torch.abs(codes).to(torch.uint8)    # |code| <= 7: int8 holds it
    sign = (codes < 0).to(torch.uint8)
    fields = (sign << (width - 1)) | mag
    return NarrowQSGDPayload(pack_bits(fields, width), payload.norms,
                             levels=payload.levels, width=width,
                             layout=payload.layout, shape=payload.shape,
                             dtype=payload.dtype)


def widen_tree_qsgd(payload: NarrowQSGDPayload) -> QSGDPayload:
    """Inverse of :func:`narrow_tree_qsgd`: the exact int8 codes."""
    width = payload.width
    fields = unpack_bits(payload.codes, width)
    mag = (fields & ((1 << (width - 1)) - 1)).to(torch.int8)
    negative = (fields >> (width - 1)) > 0
    codes = torch.where(negative, -mag, mag)
    return QSGDPayload(codes, payload.norms, levels=payload.levels,
                       layout=payload.layout, shape=payload.shape,
                       dtype=payload.dtype)


def payload_spec(comp, d: int, *, bucket: int = None, narrow: bool = False):
    """The flat-engine payload of a d-element model, as meta tensors of
    the shapes :func:`pack_tree` gives (``nbits`` reads them)."""
    b = _clamp_bucket(int(bucket or _engine_bucket(comp)), d)
    n_buckets = -(-d // b)
    if comp.name == "natural":
        return NaturalPayload(spec_tensor((n_buckets, b), torch.uint8),
                              spec_tensor((n_buckets, b // 8), torch.uint8))
    norms = spec_tensor((n_buckets, 1))
    if narrow:
        width = _narrow_width(comp.levels)
        return NarrowQSGDPayload(
            spec_tensor((n_buckets, b * width // 8), torch.uint8), norms,
            levels=comp.levels, width=width)
    return QSGDPayload(spec_tensor((n_buckets, b), torch.int8), norms,
                       levels=comp.levels)


# --------------------------------------------------------------------------
# the server side: one-pass masked mean of a stacked payload batch
# --------------------------------------------------------------------------

def supports_fused_reduce(payload) -> bool:
    """True for stacked flat-engine payloads the one-pass server reduce
    consumes directly (narrow QSGD payloads widen first)."""
    return isinstance(payload,
                      (QSGDPayload, NaturalPayload, NarrowQSGDPayload)) \
        and payload.layout is not None


def payload_finite_mask(payload) -> torch.Tensor:
    """(n,) 0/1 float32 over a stacked payload batch: 1 where client i's
    message decodes entirely finite — all its QSGD bucket norms finite,
    or no natural exponent code 255 (±Inf)."""
    if isinstance(payload, NaturalPayload):
        ok = payload.exps != 255
    else:
        ok = torch.isfinite(payload.norms)
    return ok.reshape(ok.shape[0], math.prod(ok.shape[1:])).all(dim=1) \
        .to(torch.float32)


def sanitize_payload(payload, finite_mask: torch.Tensor):
    """Zero the scale-carrying wire tensors of non-finite clients (QSGD
    norms -> 0, natural exponent codes -> 0, which decode to ±0): NaN * 0
    weight is still NaN, so a zero reduce weight alone cannot keep a
    poisoned payload out.  For all-finite payloads the result is
    bit-identical to the input."""
    if isinstance(payload, NaturalPayload):
        m = finite_mask.reshape((-1,) + (1,) * (payload.exps.dim() - 1))
        return dataclasses.replace(payload, exps=torch.where(
            m > 0, payload.exps, torch.zeros_like(payload.exps)))
    m = finite_mask.reshape((-1,) + (1,) * (payload.norms.dim() - 1))
    norms = torch.where(m > 0, payload.norms, torch.zeros_like(payload.norms))
    return dataclasses.replace(payload, norms=norms)


def reduce_payload_acc(payload, weights) -> torch.Tensor:
    """The raw (n_buckets, bucket) accumulator ``sum_i w_i *
    decode(payload_i)`` of a stacked batch (``weights`` (n,) or None);
    narrow QSGD payloads widen to their exact int8 codes first."""
    if isinstance(payload, NarrowQSGDPayload):
        payload = widen_tree_qsgd(payload)
    if isinstance(payload, NaturalPayload):
        return natural_reduce(payload.exps, payload.signs, weights)
    return qsgd_reduce(payload.codes, payload.norms, weights,
                       levels=payload.levels)


def reduce_payload_mean(payload, mask=None):
    """The (optionally mask-weighted) MEAN tree of a stacked payload
    batch in ONE pass (DESIGN.md §10).  Clients whose message decodes
    non-finite leave both the numerator and the denominator; if none is
    left the denominator clamps to 1 and the mean is the zeros tree."""
    if not supports_fused_reduce(payload):
        raise ValueError(
            f"no fused reduce for payload {type(payload).__name__}; "
            "expected a stacked flat-engine QSGDPayload/NaturalPayload "
            "carrying its FlatLayout")
    layout = payload.layout
    if layout.d == 0:
        return unravel(layout, torch.zeros((0,), device=_wire(payload).device))
    if isinstance(payload, NarrowQSGDPayload):
        payload = widen_tree_qsgd(payload)
    fin = payload_finite_mask(payload)
    weights = fin if mask is None else \
        mask.reshape(-1).to(torch.float32) * fin
    payload = sanitize_payload(payload, fin)
    denom = torch.sum(weights)
    acc = reduce_payload_acc(payload, weights)
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    return unravel(layout, unbucketize(acc / safe, layout.d))


def payload_wire_bits(payload) -> int:
    """Exact bits moved by a payload — reads ``Payload.nbits``."""
    return int(payload.nbits)


def packed_wire_bits(tree, *, bucket: int = 2048) -> int:
    """Exact packed QSGD payload size of a tree, without building it: 8
    bits a code (padding included; a sub-bucket model clamps to the next
    lane multiple) plus a 32-bit norm a bucket.  An empty tree costs 0."""
    layout = layout_of(tree, bucket)
    if layout.d == 0:
        return 0
    layout = layout_of(tree, _clamp_bucket(bucket, layout.d))
    return layout.padded * 8 + layout.n_buckets * 32
