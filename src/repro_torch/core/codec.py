"""Wire-first codec layer: payloads and the per-model CompressionPlan —
the counterpart of ``repro.core.codec``.

  * a payload carries the ACTUAL wire tensors of one compressed message
    and an exact ``nbits``: :class:`DensePayload` (identity),
    :class:`QSGDPayload` (integer codes + one float32 norm per bucket),
    :class:`NaturalPayload` (uint8 exponent codes + packed sign bitmap),
    :class:`TernPayload`, :class:`SparsePayload` (rand-k / top-k),
    :class:`BernoulliPayload`, :class:`NarrowQSGDPayload` (sub-byte QSGD
    codes) and :class:`TreePayload` (one payload per leaf);
  * a :class:`CompressionPlan` is built once per model by
    :func:`make_plan` from (codec, transport, one-model shapes);
    ``round_bits()`` is the wire cost of one message, the ``nbits`` of a
    payload of meta tensors shaped as the encoder shapes its output (the
    counterpart of the reference's ``jax.eval_shape`` over ``encode``).

Transports, as in the reference:

  leafwise — per-leaf encode/decode (every codec)
  flat     — whole-tree flat-buffer engine; ``apply`` is one fused
             launch (qsgd / natural; :mod:`.flatbuf`)
  packed   — the same payload as ``flat``, and ``apply`` materializes
             it (encode -> decode)

A tree with a leading client axis is encoded by passing one key per
client, the reference's ``vmap(plan.encode)`` written out as a batch
dimension; every payload then carries that axis first.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.kernels.bits import (natural_merge, natural_split,
                                      pack_bits, unpack_bits)

__all__ = [
    "DensePayload", "QSGDPayload", "NaturalPayload", "TernPayload",
    "SparsePayload", "BernoulliPayload", "NarrowQSGDPayload", "TreePayload",
    "CompressionPlan", "make_plan", "as_plan", "TRANSPORTS", "index_bits",
    "pack_bits", "unpack_bits", "natural_split", "natural_merge",
    "decode_payload", "plan_spec", "plan_from_spec", "spec_tensor",
]

TRANSPORTS = ("leafwise", "flat", "packed")

#: "argument not given" marker of the deprecated ``flat=`` keywords
_UNSET = object()


def _legacy_transport(flat, where: str) -> Optional[str]:
    """The ``flat=`` deprecation shim of the legacy keyword sites
    (``compressors.tree_apply``, ``tree_wire_bits``): warn with the plan
    spelling and map the boolean to a transport name (None stays None =
    auto)."""
    warnings.warn(
        f"{where} is deprecated; build a CompressionPlan once per model "
        "(repro_torch.core.codec.make_plan(comp, params, transport="
        "'flat'|'leafwise'|'packed')) and use plan.apply / "
        "plan.round_bits()", DeprecationWarning, stacklevel=3)
    if flat is None:
        return None
    return "flat" if flat else "leafwise"


def _nelem(shape) -> int:
    return int(np.prod(shape)) if len(shape) else 1


def _itembits(t: torch.Tensor) -> float:
    return 8.0 * t.element_size()


def spec_tensor(shape, dtype=torch.float32) -> torch.Tensor:
    """A payload field's shape and dtype without storage (a meta tensor):
    the payloads ``round_bits`` measures are built of these."""
    return torch.empty(shape, dtype=dtype, device="meta")


def index_bits(d: int) -> float:
    """Wire width of one coordinate index into a size-``d`` array:
    ceil(log2 d), never below 1."""
    if d <= 1:
        return 1.0
    return float(max(math.ceil(math.log2(d)), 1))


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
    """QSGD wire message: sign*magnitude integer codes (int8 while
    ``levels <= 127``, int16 beyond) plus one float32 norm per bucket.
    The flat engine carries codes in the bucketized (..., n_buckets,
    bucket) view (padding included) and its one-model
    :class:`~repro_torch.core.flatbuf.FlatLayout`; the leafwise codec
    carries the unpadded (..., d) prefix."""

    codes: Any
    norms: Any
    levels: int = 127
    layout: Any = None
    shape: Optional[tuple] = None
    dtype: Any = None

    @property
    def nbits(self) -> float:
        return (float(self.codes.numel()) * _itembits(self.codes)
                + 32.0 * float(self.norms.numel()))


@dataclasses.dataclass(frozen=True)
class NaturalPayload:
    """Natural-compression wire message: one uint8 biased-exponent code
    per element plus the packed sign bitmap (8 signs per byte) — 9
    bits per element."""

    exps: Any
    signs: Any
    layout: Any = None
    shape: Optional[tuple] = None
    dtype: Any = None

    @property
    def nbits(self) -> float:
        return 8.0 * float(self.exps.numel()) + 8.0 * float(self.signs.numel())


@dataclasses.dataclass(frozen=True)
class TernPayload:
    """TernGrad wire message: packed 2-bit ternary fields (4 per byte;
    0 -> 0, 1 -> +1, 2 -> -1) plus one float32 max-norm per bucket."""

    codes: Any
    scales: Any
    bucket: int = 2048
    shape: Optional[tuple] = None
    dtype: Any = None

    @property
    def nbits(self) -> float:
        return 8.0 * float(self.codes.numel()) \
            + 32.0 * float(self.scales.numel())


@dataclasses.dataclass(frozen=True)
class SparsePayload:
    """rand-k / top-k wire message: the k surviving (index, value) pairs;
    indices are int32 tensors charged at ``index_bits(d)``."""

    indices: Any
    values: Any
    shape: Optional[tuple] = None
    dtype: Any = None

    @property
    def nbits(self) -> float:
        d = _nelem(self.shape) if self.shape is not None else 0
        return float(self.indices.numel()) * index_bits(d) \
            + 32.0 * float(self.values.numel())


@dataclasses.dataclass(frozen=True)
class BernoulliPayload:
    """Bernoulli-sparsifier wire message: the exact survivor bitmap plus
    the dense scaled values; ``nbits`` charges the bitmap exactly and the
    EXPECTED compacted values, 32 * q * d (DESIGN.md §7)."""

    mask: Any
    values: Any
    q: float = 0.25
    shape: Optional[tuple] = None
    dtype: Any = None

    @property
    def nbits(self) -> float:
        return 8.0 * float(self.mask.numel()) \
            + 32.0 * float(self.q) * float(self.values.numel())


@dataclasses.dataclass(frozen=True)
class NarrowQSGDPayload:
    """A flat-engine :class:`QSGDPayload` with ``levels <= 7`` repacked
    into ``width``-bit sign-magnitude fields (sign in the top bit), 8 /
    width per byte; ``flatbuf.widen_tree_qsgd`` restores the int8 codes
    bit for bit."""

    codes: Any                         # packed uint8 (..., nb, bucket*width/8)
    norms: Any
    levels: int = 7
    width: int = 4
    layout: Any = None
    shape: Optional[tuple] = None
    dtype: Any = None

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


def decode_payload(payload, codec=None):
    """Standalone dequantize of any payload: flat-engine payloads carry
    their layout and need no codec; leaf payloads and
    :class:`TreePayload` decode with the codec that produced them (the
    bucket geometry lives on the compressor); a :class:`DensePayload`
    decodes without one."""
    from repro_torch.core import flatbuf
    if isinstance(payload, (QSGDPayload, NaturalPayload, NarrowQSGDPayload)) \
            and payload.layout is not None:
        return flatbuf.unpack_tree(payload)
    if isinstance(payload, TreePayload):
        if codec is None:
            raise ValueError("decode_payload(TreePayload) needs the codec "
                             "that produced the per-leaf payloads")
        return tree_unflatten(payload.treedef,
                              [codec.decode(p) for p in payload.leaves])
    if isinstance(payload, DensePayload) and codec is None:
        v = payload.values
        return v.reshape(tuple(v.shape[:-1]) + tuple(payload.shape)) \
            .to(payload.dtype)
    if codec is None:
        raise ValueError(f"decode_payload({type(payload).__name__}) needs "
                         "its codec (bucket geometry lives on the "
                         "compressor)")
    return codec.decode(payload)


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
    narrow: bool = False                # sub-byte QSGD wire (levels <= 7)

    def bind(self, params) -> "CompressionPlan":
        """A copy bound to ``params``' shapes (enables ``round_bits``)."""
        specs = tree_map(lambda a: torch.empty(tuple(a.shape), device="meta"),
                         params)
        return dataclasses.replace(self, specs=specs)

    # -- wire path ----------------------------------------------------------
    def encode(self, key, tree):
        """Quantize a tree to its wire payload.  Keys (n, 2) with a tree
        whose leaves carry a leading client axis n encode n messages in
        one batched call per leaf (leafwise) or one launch (flat engine)
        — the reference's ``vmap(plan.encode)``."""
        if self.transport == "leafwise":
            leaves, treedef = tree_flatten(tree)
            keys = prng.split(key, max(len(leaves), 1))
            return TreePayload(tuple(self.codec.encode(keys[..., j, :], leaf)
                                     for j, leaf in enumerate(leaves)),
                               treedef)
        from repro_torch.core import flatbuf
        payload = flatbuf.pack_tree(self.codec, key, tree, bucket=self.bucket)
        if self.narrow:
            payload = flatbuf.narrow_tree_qsgd(payload)
        return payload

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
        payload.  Leafwise: leaf j uses ``split(key, n_leaves)[j]``, and
        keys (n, 2) apply n clients' codecs in one call per leaf."""
        if self.transport == "flat":
            from repro_torch.core import flatbuf
            return flatbuf.flat_tree_apply(self.codec, key, tree,
                                           bucket=self.bucket)
        if self.transport == "packed":
            return self.decode(self.encode(key, tree))
        leaves, treedef = tree_flatten(tree)
        keys = prng.split(key, max(len(leaves), 1))
        return tree_unflatten(treedef,
                              [self.codec.apply(keys[..., j, :], leaf)
                               for j, leaf in enumerate(leaves)])

    # -- accounting ---------------------------------------------------------
    def round_bits(self) -> float:
        """Exact wire bits of ONE message under this plan: the ``nbits``
        of the payload the encoder would build for the bound one-model
        shapes, evaluated on meta tensors of the payload's shapes."""
        if self.specs is None:
            raise ValueError(
                "unbound plan: build with make_plan(codec, params, ...) or "
                "call plan.bind(params) before round_bits()")
        shapes = [tuple(a.shape) for a in tree_flatten(self.specs)[0]]
        if self.transport == "leafwise":
            return float(TreePayload(tuple(self.codec.payload_spec(s)
                                           for s in shapes)).nbits)
        from repro_torch.core import flatbuf
        d = sum(_nelem(s) for s in shapes)
        return float(flatbuf.payload_spec(self.codec, d, bucket=self.bucket,
                                          narrow=self.narrow).nbits)


def make_plan(codec, params=None, *, transport: Optional[str] = None,
              bucket: Optional[int] = None,
              narrow: bool = False) -> CompressionPlan:
    """Build the once-per-model :class:`CompressionPlan`; ``transport=None``
    picks ``"flat"`` for codecs with a flat engine (qsgd, natural) and
    ``"leafwise"`` otherwise, as the reference does.  ``narrow=True``
    carries flat/packed QSGD codes (``levels <= 7``) as 4-bit (2-bit at
    levels 1) fields."""
    from repro_torch.core import flatbuf
    name = getattr(codec, "name", codec)
    if transport is None:
        transport = "flat" if flatbuf.supports_flat(codec) else "leafwise"
    if transport not in TRANSPORTS:
        raise ValueError(f"unknown transport {transport!r}; "
                         f"have {TRANSPORTS}")
    if transport in ("flat", "packed") and not flatbuf.supports_flat(codec):
        raise ValueError(f"transport {transport!r} needs a flat-engine "
                         f"codec (qsgd/natural), got {name!r}")
    if transport in ("flat", "packed") and name == "qsgd" \
            and codec.levels > 127:
        raise ValueError(f"levels={codec.levels} does not fit the flat "
                         "engine's int8 wire payload; use transport="
                         "'leafwise' (int16 codes) or levels <= 127")
    if narrow:
        if transport not in ("flat", "packed"):
            raise ValueError("narrow=True needs the flat-engine payload "
                             "(transport='flat' or 'packed'), not "
                             f"{transport!r}")
        if name != "qsgd":
            raise ValueError("narrow=True is a QSGD sub-byte repack; got "
                             f"codec {name!r}")
        if codec.levels > 7:
            raise ValueError(f"levels={codec.levels} does not fit a 4-bit "
                             "narrow code (sign + 3 magnitude bits); use "
                             "levels <= 7 or narrow=False")
    plan = CompressionPlan(codec=codec, transport=transport, bucket=bucket,
                           narrow=narrow)
    return plan.bind(params) if params is not None else plan


def plan_spec(plan: CompressionPlan) -> dict:
    """Serializable recipe of a plan built from a registry compressor:
    name + constructor kwargs + transport / bucket / narrow, enough for
    :func:`plan_from_spec` to rebuild an equivalent plan."""
    comp = plan.codec
    kwargs = {f.name: getattr(comp, f.name)
              for f in dataclasses.fields(comp) if f.init}
    return {"codec": comp.name, "kwargs": kwargs,
            "transport": plan.transport, "bucket": plan.bucket,
            "narrow": plan.narrow}


def plan_from_spec(spec: dict) -> CompressionPlan:
    from repro_torch.core.compressors import make_compressor
    comp = make_compressor(spec["codec"], **spec.get("kwargs", {}))
    return make_plan(comp, transport=spec["transport"],
                     bucket=spec.get("bucket"),
                     narrow=spec.get("narrow", False))


def as_plan(codec_or_plan, transport: Optional[str] = None,
            params=None) -> CompressionPlan:
    """Coerce a compressor (or return a plan as-is) to a CompressionPlan."""
    if isinstance(codec_or_plan, CompressionPlan):
        return codec_or_plan
    return make_plan(codec_or_plan, params, transport=transport)
