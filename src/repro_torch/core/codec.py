"""Wire-first codec layer: payloads and the per-model CompressionPlan —
the counterpart of ``repro.core.codec`` for this slice of the port.

  * a payload carries the ACTUAL wire tensors of one compressed message
    and an exact ``nbits``: :class:`DensePayload` (identity),
    :class:`QSGDPayload` (int8 codes + one float32 norm per bucket) and
    :class:`TreePayload` (one payload per leaf);
  * a :class:`CompressionPlan` is built once per model by
    :func:`make_plan` from (codec, transport, one-model shapes);
    ``round_bits()`` is the wire cost of one message, from shape
    arithmetic on the same layout the encoder uses (DESIGN.md §3).

Transports, as in the reference:

  leafwise — per-leaf encode/decode.  Here only the identity codec
             (dense payloads); the leafwise codecs are slice 2 of the
             port (ROADMAP.md).
  flat     — whole-tree flat-buffer engine; ``apply`` is one fused
             quantize-dequantize launch (QSGD; :mod:`.flatbuf`)
  packed   — the same payload as ``flat``, and ``apply`` materializes
             it (encode -> decode)

A tree with a leading client axis is encoded by passing one key per
client, the reference's ``vmap(plan.encode)`` written out as a batch
dimension.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten

__all__ = ["DensePayload", "QSGDPayload", "TreePayload", "CompressionPlan",
           "make_plan", "as_plan", "TRANSPORTS"]

TRANSPORTS = ("leafwise", "flat", "packed")

_SLICE2 = ("is not ported yet: the natural codec, the leafwise codecs and "
           "the narrow QSGD wire are slice 2 of the port (ROADMAP.md)")


def _nelem(shape) -> int:
    return int(np.prod(shape)) if len(shape) else 1


def _itembits(t: torch.Tensor) -> float:
    return 8.0 * t.element_size()


@dataclasses.dataclass(frozen=True)
class DensePayload:
    """Uncompressed transport (identity codec): the raw float32 values."""

    values: Any
    shape: Optional[tuple] = None
    dtype: Any = None

    @property
    def nbits(self) -> float:
        return float(self.values.numel()) * _itembits(self.values)


@dataclasses.dataclass(frozen=True)
class QSGDPayload:
    """QSGD wire message: int8 sign*magnitude codes in the bucketized
    (..., n_buckets, bucket) view (padding included) plus one float32
    norm per bucket (..., n_buckets, 1).  ``layout`` is the one-model
    :class:`~repro_torch.core.flatbuf.FlatLayout`."""

    codes: Any
    norms: Any
    levels: int = 127
    layout: Any = None

    @property
    def nbits(self) -> float:
        return (float(self.codes.numel()) * _itembits(self.codes)
                + 32.0 * float(self.norms.numel()))


@dataclasses.dataclass(frozen=True)
class TreePayload:
    """Leafwise transport: one payload per leaf, in tree-flatten order."""

    leaves: tuple
    treedef: Any = None

    @property
    def nbits(self) -> float:
        return float(sum(p.nbits for p in self.leaves))


@dataclasses.dataclass(frozen=True, eq=False)
class CompressionPlan:
    """One model's compression recipe: (codec, transport, shapes).

    ``specs`` holds the one-model leaf shapes ``round_bits`` measures
    (as meta tensors, the counterpart of ShapeDtypeStructs);
    layouts are recomputed from the tree actually passed in."""

    codec: Any
    transport: str = "leafwise"
    specs: Any = None                   # one-model tree of meta tensors
    bucket: Optional[int] = None        # flat-engine bucket override

    def bind(self, params) -> "CompressionPlan":
        """A copy bound to ``params``' shapes (enables ``round_bits``)."""
        specs = tree_map(lambda a: torch.empty(tuple(a.shape), device="meta"),
                         params)
        return dataclasses.replace(self, specs=specs)

    # -- wire path ----------------------------------------------------------
    def encode(self, key, tree):
        """Quantize a tree to its wire payload.  The flat engine also
        takes keys (n, 2) with a tree whose leaves carry a leading client
        axis n — the uplink of ``compressed_average``, one batched launch
        for the reference's ``vmap(plan.encode)``."""
        if self.transport == "leafwise":
            leaves, treedef = tree_flatten(tree)
            keys = prng.split(key, max(len(leaves), 1))
            return TreePayload(tuple(self.codec.encode(k, leaf)
                                     for k, leaf in zip(keys, leaves)),
                               treedef)
        from repro_torch.core import flatbuf
        return flatbuf.pack_tree(self.codec, key, tree, bucket=self.bucket)

    def decode(self, payload):
        """Dequantize a payload back to the tree."""
        if isinstance(payload, TreePayload):
            return tree_unflatten(payload.treedef,
                                  [self.codec.decode(p)
                                   for p in payload.leaves])
        from repro_torch.core import flatbuf
        return flatbuf.unpack_tree(payload)

    def apply(self, key, tree):
        """C(tree) == decode(encode(key, tree)) bit for bit; the flat
        transport takes the fused kernel, packed materializes the
        payload."""
        if self.transport == "flat":
            from repro_torch.core import flatbuf
            return flatbuf.flat_tree_apply(self.codec, key, tree,
                                           bucket=self.bucket)
        if self.transport == "packed":
            return self.decode(self.encode(key, tree))
        leaves, treedef = tree_flatten(tree)
        keys = prng.split(key, max(len(leaves), 1))
        return tree_unflatten(treedef, [self.codec.apply(k, leaf)
                                        for k, leaf in zip(keys, leaves)])

    # -- accounting ---------------------------------------------------------
    def round_bits(self) -> float:
        """Exact wire bits of ONE message under this plan, from the
        payload geometry of the bound one-model shapes."""
        if self.specs is None:
            raise ValueError(
                "unbound plan: build with make_plan(codec, params, ...) or "
                "call plan.bind(params) before round_bits()")
        shapes = [tuple(a.shape) for a in tree_flatten(self.specs)[0]]
        if self.transport == "leafwise":
            # DensePayload per leaf: 32 bits per element
            return float(sum(32.0 * _nelem(s) for s in shapes))
        from repro_torch.core import flatbuf
        bucket = int(self.bucket or flatbuf._engine_bucket(self.codec))
        d = sum(_nelem(s) for s in shapes)
        if d == 0:
            return 0.0
        bucket = flatbuf._clamp_bucket(bucket, d)
        n_buckets = -(-d // bucket)
        return float(n_buckets * bucket * 8 + n_buckets * 32)


def make_plan(codec, params=None, *, transport: Optional[str] = None,
              bucket: Optional[int] = None,
              narrow: bool = False) -> CompressionPlan:
    """Build the once-per-model :class:`CompressionPlan`; ``transport=None``
    picks ``"flat"`` for codecs with a flat engine (QSGD) and
    ``"leafwise"`` otherwise, as the reference does."""
    from repro_torch.core import flatbuf
    if narrow:
        raise NotImplementedError(f"narrow=True {_SLICE2}")
    if transport is None:
        transport = "flat" if flatbuf.supports_flat(codec) else "leafwise"
    if transport not in TRANSPORTS:
        raise ValueError(f"unknown transport {transport!r}; "
                         f"have {TRANSPORTS}")
    name = getattr(codec, "name", codec)
    if transport in ("flat", "packed") and not flatbuf.supports_flat(codec):
        raise ValueError(f"transport {transport!r} needs a flat-engine "
                         f"codec (qsgd), got {name!r}")
    if transport == "leafwise" and name != "identity":
        raise NotImplementedError(f"leafwise {name!r} {_SLICE2}")
    if transport in ("flat", "packed") and codec.levels > 127:
        raise ValueError(f"levels={codec.levels} does not fit the flat "
                         "engine's int8 wire payload; use levels <= 127")
    plan = CompressionPlan(codec=codec, transport=transport, bucket=bucket)
    return plan.bind(params) if params is not None else plan


def as_plan(codec_or_plan, transport: Optional[str] = None,
            params=None) -> CompressionPlan:
    """Coerce a compressor (or return a plan as-is) to a CompressionPlan."""
    if isinstance(codec_or_plan, CompressionPlan):
        return codec_or_plan
    return make_plan(codec_or_plan, params, transport=transport)
