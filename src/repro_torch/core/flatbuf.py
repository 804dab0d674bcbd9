"""Flat-buffer compression engine — the counterpart of
``repro.core.flatbuf`` for the QSGD codec.

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
  pack_tree / unpack_tree       — whole-tree QSGD wire payloads, bit-exact
                                  against flat_tree_apply
  payload_finite_mask / sanitize_payload / reduce_payload_acc /
  reduce_payload_mean           — the server's one-pass masked mean of a
                                  stacked payload batch, O(d) state
                                  (DESIGN.md §10)
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.codec import QSGDPayload
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.kernels.qsgd.kernel import (check_levels, qsgd_fused,
                                             qsgd_pack, qsgd_unpack)
from repro_torch.kernels.qsgd.ops import qsgd_reduce

__all__ = [
    "FlatLayout", "layout_of", "ravel", "unravel", "bucketize",
    "unbucketize", "seeds_of", "supports_flat", "flat_tree_apply",
    "pack_tree", "pack_tree_qsgd", "unpack_tree", "payload_finite_mask",
    "sanitize_payload", "reduce_payload_acc", "reduce_payload_mean",
]

_LANE = 128          # sub-bucket models pad to the next multiple of this
_GOLDEN = np.uint32(0x9E3779B9)


def supports_flat(comp) -> bool:
    """True for compressors with a flat-engine kernel in this slice."""
    return getattr(comp, "name", None) == "qsgd"


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


def ravel(layout: FlatLayout, tree) -> torch.Tensor:
    """Concatenate all leaves into one (..., d) float32 buffer (``...`` is
    the batch shape).  A single-leaf tree is a reshape, not a copy."""
    leaves = tree_flatten(tree)[0]
    if not leaves:
        return torch.zeros((0,), dtype=torch.float32)
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
    under the same key."""
    if not supports_flat(comp):
        raise ValueError(f"no flat engine for compressor {comp!r}")
    bucket = int(bucket or _engine_bucket(comp))
    layout = layout_of(tree, bucket)
    if layout.d == 0:
        return tree
    bucket = _clamp_bucket(bucket, layout.d)
    layout = layout_of(tree, bucket)
    x2d = bucketize(ravel(layout, tree), bucket).contiguous()
    y2d = qsgd_fused(x2d, seeds_of(key), levels=comp.levels)
    return unravel(layout, unbucketize(y2d, layout.d))


def pack_tree(comp, key, tree, *, bucket: int = None):
    """Quantize a tree to its wire payload — the encode of the flat and
    packed transports.  ``key`` (2,) encodes one model; keys (n, 2)
    encode a stacked tree of n models (leading client axis)."""
    if not supports_flat(comp):
        raise ValueError(f"no flat engine for compressor {comp!r}")
    bucket = int(bucket or _engine_bucket(comp))
    return pack_tree_qsgd(key, tree, levels=comp.levels, bucket=bucket)[0]


def pack_tree_qsgd(key, tree, *, levels: int = 127, bucket: int = 2048):
    """QSGD payload of one model (``key`` (2,)) or of a stacked tree
    (``key`` (n, 2)).  Returns (payload, one-model layout)."""
    check_levels(levels)
    keys = np.asarray(key, np.uint32)
    batch_dims = keys.ndim - 1
    layout = layout_of(tree, bucket, batch_dims=batch_dims)
    leaves = tree_flatten(tree)[0]
    device = leaves[0].device if leaves else torch.device("cpu")
    if layout.d == 0:
        batch = keys.shape[:-1]
        payload = QSGDPayload(
            torch.zeros(batch + (0, bucket), dtype=torch.int8, device=device),
            torch.zeros(batch + (0, 1), dtype=torch.float32, device=device),
            levels=levels, layout=layout)
        return payload, layout
    bucket = _clamp_bucket(bucket, layout.d)
    layout = layout_of(tree, bucket, batch_dims=batch_dims)
    x2d = bucketize(ravel(layout, tree), bucket).contiguous()
    codes, norms = qsgd_pack(x2d, seeds_of(keys), levels=levels)
    return QSGDPayload(codes, norms, levels=levels, layout=layout), layout


def unpack_tree(payload: QSGDPayload):
    """Dequantize a payload (one model, or a stacked batch) back to its
    tree — bit-exact vs :func:`flat_tree_apply` under the same key."""
    layout = payload.layout
    if layout is None:
        raise ValueError("payload carries no FlatLayout; it was not "
                         "produced by the flat engine (pack_tree)")
    codes = payload.codes
    batch = tuple(codes.shape[:-2])
    if layout.d == 0:
        return unravel(layout, torch.zeros(batch + (0,), device=codes.device))
    b = codes.shape[-1]
    y2d = qsgd_unpack(codes.reshape(-1, b), payload.norms.reshape(-1, 1),
                      levels=payload.levels)
    return unravel(layout, unbucketize(y2d.reshape(codes.shape), layout.d))


# --------------------------------------------------------------------------
# the server side: one-pass masked mean of a stacked payload batch
# --------------------------------------------------------------------------

def payload_finite_mask(payload: QSGDPayload) -> torch.Tensor:
    """(n,) 0/1 float32 over a stacked payload batch: 1 where client i's
    message decodes entirely finite (all its bucket norms are finite)."""
    norms = payload.norms
    return torch.isfinite(norms).reshape(norms.shape[0], -1).all(dim=1) \
        .to(torch.float32)


def sanitize_payload(payload: QSGDPayload, finite_mask: torch.Tensor):
    """Zero the norms of non-finite clients: NaN * 0 weight is still NaN,
    so a zero reduce weight alone cannot keep a poisoned payload out.
    For all-finite payloads the result is bit-identical to the input."""
    m = finite_mask.reshape((-1,) + (1,) * (payload.norms.dim() - 1))
    norms = torch.where(m > 0, payload.norms, torch.zeros_like(payload.norms))
    return dataclasses.replace(payload, norms=norms)


def reduce_payload_acc(payload: QSGDPayload, weights) -> torch.Tensor:
    """The raw (n_buckets, bucket) accumulator ``sum_i w_i *
    decode(payload_i)`` of a stacked batch (``weights`` (n,) or None)."""
    return qsgd_reduce(payload.codes, payload.norms, weights,
                       levels=payload.levels)


def reduce_payload_mean(payload: QSGDPayload, mask=None):
    """The (optionally mask-weighted) MEAN tree of a stacked payload
    batch in ONE pass (DESIGN.md §10).  Clients whose message decodes
    non-finite leave both the numerator and the denominator; if none is
    left the denominator clamps to 1 and the mean is the zeros tree."""
    if not isinstance(payload, QSGDPayload) or payload.layout is None:
        raise ValueError(
            f"no fused reduce for payload {type(payload).__name__}; "
            "expected a stacked flat-engine QSGDPayload carrying its "
            "FlatLayout")
    layout = payload.layout
    if layout.d == 0:
        return unravel(layout, torch.zeros((0,), device=payload.codes.device))
    fin = payload_finite_mask(payload)
    weights = fin if mask is None else \
        mask.reshape(-1).to(torch.float32) * fin
    payload = sanitize_payload(payload, fin)
    denom = torch.sum(weights)
    acc = reduce_payload_acc(payload, weights)
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    return unravel(layout, unbucketize(acc / safe, layout.d))
