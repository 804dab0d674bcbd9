"""Compressors (the paper's §IV-A, Table I) — the counterpart of
``repro.core.compressors``: identity, qsgd, natural, terngrad, bernoulli,
rand-k (all unbiased) and top-k (biased).

Each compressor is a Codec:

  * ``encode(key, x) -> payload`` flattens ``x`` to float32 and records
    its shape and dtype on the payload (:mod:`repro_torch.core.codec`);
  * ``decode(payload) -> x`` reshapes back;
  * ``apply(key, x)`` equals ``decode(encode(key, x))``; the elementwise
    codecs (identity, natural, bernoulli) take a fast path that skips the
    payload.

``key`` is two uint32 words; keys (n, 2) with an ``x`` of leading axis n
compress n clients' arrays in one call, each with its own key (the
reference's vmap).  ``encode`` and ``apply`` also take ``offset``: ``x``
is then the slice of a larger array whose flattened elements start there,
and its compression is that slice of the larger array's, bit for bit
(the draws start at counter ``offset``).  ``slice_unit()`` says which
offsets a codec takes: any for the elementwise codecs, a multiple of the
bucket for the bucketed ones (QSGD, TernGrad; the slice then ends on a
bucket too, or at the array's end), none for rand-k and top-k, which see
the whole array at once.  The randomness is the reference's: threefry draws of
``jax.random.uniform`` / ``bernoulli`` / ``permutation`` over the same
shapes, made on the tensor's device (:mod:`repro_torch.core.prng`).
Float rounding follows XLA:CPU's: a division by a constant (``x / q``,
``norm / levels``) is a multiply by the float32 reciprocal, a division by
a runtime value stays an IEEE division.

Natural compression rounds in the bits domain and passes a value through
unchanged only where its exponent field is 255; subnormals round (the
reference's jitted jnp compares ``x == 0`` with denormals-are-zero and
passes them through — ``repro_torch/kernels/natural/ref.py``).

``QSGD.apply`` and natural compression run on the hand-written kernels
of the explicit-noise TPU kernels (``kernels.qsgd.kernel.
qsgd_dequantized``, ``kernels.natural.kernel.natural_compress_2d``) with
the threefry draw as their noise: one launch per leaf and call, the
client batch included; a CPU tensor runs their plain versions.
``QSGD.apply`` equals ``decode(encode)`` in value; where x < 0 rounds to
level 0 it gives -0.0 (the TPU kernel's sign), the payload's integer
code +0.0.  The other five codecs are plain PyTorch: the reference has
no kernel for them.

QSGD and natural also run whole trees through the flat-buffer engine
(:mod:`repro_torch.core.flatbuf`, one kernel launch per tree).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import flatbuf, prng
from repro_torch.core.codec import (_UNSET, BernoulliPayload,
                                    DensePayload, NaturalPayload,
                                    QSGDPayload, SparsePayload, TernPayload,
                                    _legacy_transport, index_bits, make_plan,
                                    spec_tensor)
from repro_torch.kernels.bits import (natural_merge, natural_split,
                                      pack_bits, unpack_bits)
from repro_torch.kernels.natural.kernel import natural_compress_2d
from repro_torch.kernels.qsgd.kernel import qsgd_dequantized
from repro_torch.kernels.qsgd.ref import qsgd_unpack_ref, quantize_with_noise

__all__ = ["Compressor", "Identity", "QSGD", "Natural", "TernGrad",
           "Bernoulli", "RandK", "TopK", "make_compressor", "tree_apply",
           "tree_wire_bits", "joint_omega"]


def _nelem(shape) -> int:
    return int(np.prod(shape)) if len(shape) else 1


def _batch_dims(key) -> int:
    """Leading axes of ``x`` that a key batch (..., 2) covers."""
    return np.asarray(key).ndim - 1


def _pad_last(t: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = (-t.shape[-1]) % multiple
    if not pad:
        return t
    return torch.cat([t, t.new_zeros(tuple(t.shape[:-1]) + (pad,))], dim=-1)


def _reciprocal(c: float) -> float:
    """float32(1 / float32(c)): XLA's constant for ``x / c``."""
    return float(np.float32(1.0) / np.float32(c))


def _sparse_k(fraction: float, d: int) -> int:
    return max(int(round(fraction * d)), 1)


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Base class / Codec protocol.  Subclasses implement
    ``_encode_flat(key, x)`` / ``_decode_flat(payload)`` on float32
    (..., d) buffers and ``_flat_spec(d)``, the payload of meta tensors
    shaped as ``_encode_flat``'s output (for ``round_bits``);
    elementwise codecs also implement ``_apply_flat``."""

    name: str = dataclasses.field(default="base", init=False)
    elementwise: bool = dataclasses.field(default=False, init=False)

    # -- public API ---------------------------------------------------------
    def encode(self, key, x: torch.Tensor, offset: int = 0):
        self._check_offset(offset)
        nb = _batch_dims(key)
        batch, shape = tuple(x.shape[:nb]), tuple(x.shape[nb:])
        flat = x.reshape(batch + (_nelem(shape),)).to(torch.float32)
        p = self._encode_flat(key, flat, offset)
        return dataclasses.replace(p, shape=shape, dtype=x.dtype)

    def decode(self, payload) -> torch.Tensor:
        y = self._decode_flat(payload)
        return y.reshape(tuple(y.shape[:-1]) + tuple(payload.shape)) \
            .to(payload.dtype)

    def apply(self, key, x: torch.Tensor, offset: int = 0) -> torch.Tensor:
        if self.elementwise:
            self._check_offset(offset)
            return self._apply_flat(key, x.to(torch.float32),
                                    offset).to(x.dtype)
        return self.decode(self.encode(key, x, offset))

    def slice_unit(self) -> int:
        """What an ``offset`` must be a multiple of (0: only offset 0,
        the codec sees the whole array at once)."""
        return 1 if self.elementwise else 0

    def _check_offset(self, offset: int) -> None:
        unit = self.slice_unit()
        if offset and (not unit or offset % unit):
            raise ValueError(f"{self.name} compresses no slice at offset "
                             f"{offset} (slice unit {unit})")

    def payload_spec(self, shape):
        """The payload of one array of ``shape``, as meta tensors."""
        return dataclasses.replace(self._flat_spec(_nelem(shape)),
                                   shape=tuple(shape))

    def omega(self, shape) -> float:
        """Variance factor omega (Assumption 1)."""
        raise NotImplementedError

    def wire_bits(self, shape) -> float:
        """Information-theoretic wire width (a lower bound for theory
        tables; the ledger charges ``CompressionPlan.round_bits()``)."""
        raise NotImplementedError

    # -- subclass hooks -----------------------------------------------------
    def _encode_flat(self, key, x, offset=0):
        raise NotImplementedError

    def _decode_flat(self, payload):
        raise NotImplementedError

    def _apply_flat(self, key, x, offset=0):
        raise NotImplementedError

    def _flat_spec(self, d: int):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Identity(Compressor):
    """No compression: omega = 0, 32 bits/element (DensePayload)."""

    name: str = dataclasses.field(default="identity", init=False)
    elementwise: bool = dataclasses.field(default=True, init=False)

    def _apply_flat(self, key, x, offset=0):
        return x

    def _encode_flat(self, key, x, offset=0):
        return DensePayload(values=x)

    def _decode_flat(self, p):
        return p.values

    def _flat_spec(self, d):
        return DensePayload(spec_tensor((d,)))

    def omega(self, shape) -> float:
        return 0.0

    def wire_bits(self, shape) -> float:
        return 32.0 * _nelem(shape)


@dataclasses.dataclass(frozen=True)
class QSGD(Compressor):
    """QSGD / random dithering [Alistarh et al. 2017] with ``levels``
    levels per bucket of ``bucket`` elements: C(x) = ||x|| sign(x) xi / s
    with xi a stochastic rounding of s|x| / ||x||.  Its wire message is
    :class:`~repro_torch.core.codec.QSGDPayload` (int8 codes while
    ``levels <= 127``, int16 beyond)."""

    levels: int = 127
    bucket: int = 2048
    name: str = dataclasses.field(default="qsgd", init=False)

    def _code_dtype(self):
        return torch.int8 if self.levels <= 127 else torch.int16

    def apply(self, key, x: torch.Tensor, offset: int = 0) -> torch.Tensor:
        """``decode(encode(key, x, offset))`` in one kernel launch: the
        buckets of every client in the batch as the rows of one buffer,
        the noise the encoder would draw."""
        self._check_offset(offset)
        nb = _batch_dims(key)
        batch, d = tuple(x.shape[:nb]), _nelem(tuple(x.shape[nb:]))
        if d == 0:
            return torch.zeros_like(x)
        xp = flatbuf.bucketize(x.reshape(batch + (d,)).to(torch.float32),
                               self.bucket)
        noise = prng.tensor_uniform(key, xp.shape[nb:], x.device, offset)
        y = qsgd_dequantized(xp.reshape(-1, self.bucket).contiguous(),
                             noise.reshape(-1, self.bucket),
                             levels=self.levels)
        return flatbuf.unbucketize(y.reshape(xp.shape), d) \
            .reshape(x.shape).to(x.dtype)

    def slice_unit(self) -> int:
        return self.bucket

    def _encode_flat(self, key, x, offset=0):
        batch, d = tuple(x.shape[:-1]), x.shape[-1]
        if d == 0:
            return QSGDPayload(
                torch.zeros(batch + (0,), dtype=self._code_dtype(),
                            device=x.device),
                torch.zeros(batch + (0, 1), device=x.device),
                levels=self.levels)
        xp = flatbuf.bucketize(x, self.bucket)
        noise = prng.tensor_uniform(key, xp.shape[len(batch):], x.device,
                                    offset)
        codes, norm = quantize_with_noise(xp, noise, self.levels)
        return QSGDPayload(flatbuf.unbucketize(codes.to(self._code_dtype()),
                                               d),
                           norm, levels=self.levels)

    def _decode_flat(self, p):
        d = p.codes.shape[-1]
        if d == 0:
            return torch.zeros(p.codes.shape, device=p.codes.device)
        codes2d = flatbuf.bucketize(p.codes.to(torch.float32), self.bucket)
        return flatbuf.unbucketize(qsgd_unpack_ref(codes2d, p.norms,
                                                   levels=p.levels), d)

    def _flat_spec(self, d):
        nb = -(-d // self.bucket)
        return QSGDPayload(spec_tensor((d,), self._code_dtype()),
                           spec_tensor((nb, 1)), levels=self.levels)

    def omega(self, shape) -> float:
        d = min(self.bucket, _nelem(shape))
        s = float(self.levels)
        return min(d / s ** 2, math.sqrt(d) / s)

    def wire_bits(self, shape) -> float:
        n = _nelem(shape)
        if n == 0:
            return 0.0
        n_buckets = math.ceil(n / self.bucket)
        return n * math.log2(2 * self.levels + 1) + 32.0 * n_buckets


@dataclasses.dataclass(frozen=True)
class Natural(Compressor):
    """Natural compression [Horvath et al. 2019]: stochastic rounding of
    the magnitude to a power of two, the exponent bumped with probability
    mantissa / 2^23 (exactly unbiased).  omega = 1/8, 9 bits/element:
    :class:`~repro_torch.core.codec.NaturalPayload`."""

    name: str = dataclasses.field(default="natural", init=False)
    elementwise: bool = dataclasses.field(default=True, init=False)

    def _apply_flat(self, key, x, offset=0):
        noise = prng.tensor_uniform(key, x.shape[_batch_dims(key):], x.device,
                                    offset)
        return natural_compress_2d(x.contiguous(), noise)

    def _encode_flat(self, key, x, offset=0):
        exps, signs = natural_split(self._apply_flat(key, x, offset))
        return NaturalPayload(exps, pack_bits(_pad_last(signs, 8), 1))

    def _decode_flat(self, p):
        d = p.exps.shape[-1]
        return natural_merge(p.exps, unpack_bits(p.signs, 1)[..., :d])

    def _flat_spec(self, d):
        return NaturalPayload(spec_tensor((d,), torch.uint8),
                              spec_tensor((-(-d // 8),), torch.uint8))

    def omega(self, shape) -> float:
        return 0.125

    def wire_bits(self, shape) -> float:
        return 9.0 * _nelem(shape)


@dataclasses.dataclass(frozen=True)
class TernGrad(Compressor):
    """TernGrad [Wen et al. 2017]: C(x) = ||x||_inf sign(x) b with b ~
    Bernoulli(|x| / ||x||_inf) per coordinate, per bucket.  Wire message:
    :class:`~repro_torch.core.codec.TernPayload`."""

    bucket: int = 2048
    name: str = dataclasses.field(default="terngrad", init=False)

    def slice_unit(self) -> int:
        return self.bucket

    def _encode_flat(self, key, x, offset=0):
        batch, d = tuple(x.shape[:-1]), x.shape[-1]
        if d == 0:
            return TernPayload(
                torch.zeros(batch + (0,), dtype=torch.uint8, device=x.device),
                torch.zeros(batch + (0, 1), device=x.device),
                bucket=self.bucket)
        xp = flatbuf.bucketize(x, self.bucket)
        mx = torch.amax(torch.abs(xp), dim=-1, keepdim=True)
        safe = torch.where(mx == 0.0, torch.ones_like(mx), mx)
        u = prng.tensor_uniform(key, xp.shape[len(batch):], x.device,
                                offset)
        tern = (u < torch.abs(xp) / safe).to(torch.float32) * torch.sign(xp)
        enc = flatbuf.unbucketize(
            torch.where(tern < 0, torch.full_like(tern, 2.0), tern), d) \
            .to(torch.uint8)
        return TernPayload(pack_bits(_pad_last(enc, 4), 2), mx,
                           bucket=self.bucket)

    def _decode_flat(self, p):
        d = _nelem(p.shape)
        batch = tuple(p.codes.shape[:-1])
        if d == 0:
            return torch.zeros(batch + (0,), device=p.codes.device)
        enc = unpack_bits(p.codes, 2)[..., :d].to(torch.float32)
        tern = torch.where(enc == 2.0, torch.full_like(enc, -1.0), enc)
        y2d = flatbuf.bucketize(tern, p.bucket) * p.scales
        return flatbuf.unbucketize(y2d, d)

    def _flat_spec(self, d):
        return TernPayload(spec_tensor((-(-d // 4),), torch.uint8),
                           spec_tensor((-(-d // self.bucket), 1)),
                           bucket=self.bucket)

    def omega(self, shape) -> float:
        d = min(self.bucket, _nelem(shape))
        return max(math.sqrt(d) - 1.0, 0.0)

    def wire_bits(self, shape) -> float:
        n = _nelem(shape)
        if n == 0:
            return 0.0
        n_buckets = math.ceil(n / self.bucket)
        return n * math.log2(3.0) + 32.0 * n_buckets


@dataclasses.dataclass(frozen=True)
class Bernoulli(Compressor):
    """Bernoulli sparsifier [Khirirat et al. 2018]: C(x)_j = x_j b_j / q,
    b_j ~ Bern(q); omega = (1 - q) / q.  Wire message:
    :class:`~repro_torch.core.codec.BernoulliPayload`."""

    q: float = 0.25
    name: str = dataclasses.field(default="bernoulli", init=False)
    elementwise: bool = dataclasses.field(default=True, init=False)

    def _draw(self, key, x, offset=0):
        return prng.tensor_bernoulli(key, self.q, x.shape[_batch_dims(key):],
                                     x.device, offset)

    def _scaled(self, b, x):
        return torch.where(b, x * _reciprocal(self.q), torch.zeros_like(x))

    def _apply_flat(self, key, x, offset=0):
        return self._scaled(self._draw(key, x, offset), x)

    def _encode_flat(self, key, x, offset=0):
        b = self._draw(key, x, offset)
        return BernoulliPayload(pack_bits(_pad_last(b.to(torch.uint8), 8), 1),
                                self._scaled(b, x), q=self.q)

    def _decode_flat(self, p):
        return p.values

    def _flat_spec(self, d):
        return BernoulliPayload(spec_tensor((-(-d // 8),), torch.uint8),
                                spec_tensor((d,)), q=self.q)

    def omega(self, shape) -> float:
        return (1.0 - self.q) / self.q

    def wire_bits(self, shape) -> float:
        n = _nelem(shape)
        if n == 0:
            return 0.0
        return self.q * n * (32.0 + index_bits(n))


def _sparse_decode(p):
    d = _nelem(p.shape)
    out = torch.zeros(tuple(p.values.shape[:-1]) + (d,),
                      device=p.values.device)
    return out.scatter_(-1, p.indices.to(torch.int64), p.values)


def _sparse_spec(fraction, d):
    k = 0 if d == 0 else _sparse_k(fraction, d)
    return SparsePayload(spec_tensor((k,), torch.int32), spec_tensor((k,)))


def _sparse_empty(x):
    batch = tuple(x.shape[:-1])
    return SparsePayload(
        torch.zeros(batch + (0,), dtype=torch.int32, device=x.device),
        torch.zeros(batch + (0,), device=x.device))


@dataclasses.dataclass(frozen=True)
class RandK(Compressor):
    """rand-k sparsifier: a uniformly random k-subset (the first k of
    ``jax.random.permutation``), scaled by d/k; omega = d/k - 1.  Wire
    message: :class:`~repro_torch.core.codec.SparsePayload`."""

    fraction: float = 0.1
    name: str = dataclasses.field(default="randk", init=False)

    def _encode_flat(self, key, x, offset=0):
        d = x.shape[-1]
        if d == 0:
            return _sparse_empty(x)
        k = _sparse_k(self.fraction, d)
        idx = prng.permutation(key, d, x.device)[..., :k]
        # x[idx] * (d / k): a multiply by the float32 of the double d / k
        values = torch.gather(x, -1, idx) * float(np.float32(d / k))
        return SparsePayload(idx.to(torch.int32), values)

    def _decode_flat(self, p):
        return _sparse_decode(p)

    def _flat_spec(self, d):
        return _sparse_spec(self.fraction, d)

    def omega(self, shape) -> float:
        d = _nelem(shape)
        return d / _sparse_k(self.fraction, d) - 1.0

    def wire_bits(self, shape) -> float:
        d = _nelem(shape)
        if d == 0:
            return 0.0
        return _sparse_k(self.fraction, d) * (32.0 + index_bits(d))


@dataclasses.dataclass(frozen=True)
class TopK(Compressor):
    """Top-k sparsifier [Aji & Heafield 2017] — BIASED (the paper's
    proof-of-concept).  Ties go to the lower index, as ``lax.top_k``
    breaks them: a stable descending sort, not ``torch.topk``.  Wire
    message: :class:`~repro_torch.core.codec.SparsePayload`."""

    fraction: float = 0.1
    name: str = dataclasses.field(default="topk", init=False)

    def _encode_flat(self, key, x, offset=0):
        d = x.shape[-1]
        if d == 0:
            return _sparse_empty(x)
        k = _sparse_k(self.fraction, d)
        idx = torch.sort(torch.abs(x), dim=-1, descending=True,
                         stable=True).indices[..., :k]
        return SparsePayload(idx.to(torch.int32), torch.gather(x, -1, idx))

    def _decode_flat(self, p):
        return _sparse_decode(p)

    def _flat_spec(self, d):
        return _sparse_spec(self.fraction, d)

    def omega(self, shape) -> float:
        # not an unbiasedness-variance factor: the contraction parameter
        d = _nelem(shape)
        return 1.0 - _sparse_k(self.fraction, d) / d

    def wire_bits(self, shape) -> float:
        d = _nelem(shape)
        if d == 0:
            return 0.0
        return _sparse_k(self.fraction, d) * (32.0 + index_bits(d))


_REGISTRY = {
    "identity": Identity,
    "qsgd": QSGD,
    "natural": Natural,
    "terngrad": TernGrad,
    "bernoulli": Bernoulli,
    "randk": RandK,
    "topk": TopK,
}


def make_compressor(name: str, **kwargs) -> Compressor:
    """Factory: ``make_compressor('qsgd', levels=15)``."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown compressor {name!r}; have "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


# --------------------------------------------------------------------------
# tree wrappers (thin shims over CompressionPlan)
# --------------------------------------------------------------------------

def tree_apply(comp: Compressor, key, tree, *, flat=_UNSET):
    """Apply a compressor to a whole tree: ``make_plan(comp).apply(key,
    tree)`` with auto transport (the flat-buffer engine for qsgd /
    natural, leafwise otherwise).  Keys (n, 2) compress a tree with a
    leading client axis n, one key per client (the reference's ``vmap``
    of this function).  ``flat=`` is a deprecated shim; pin transports
    on a plan instead."""
    transport = None
    if flat is not _UNSET:
        transport = _legacy_transport(flat, "tree_apply(..., flat=)")
    return make_plan(comp, transport=transport).apply(key, tree)


def tree_wire_bits(comp: Compressor, tree, *, flat=_UNSET,
                   transport=None) -> float:
    """Exact wire bits to send a compressed tree once — the plan's
    ``round_bits()`` (the ``nbits`` of the payload ``encode`` builds).
    ``flat=`` is a deprecated shim for ``transport=``."""
    if flat is not _UNSET:
        legacy = _legacy_transport(flat, "tree_wire_bits(..., flat=)")
        transport = transport if transport is not None else legacy
    return make_plan(comp, tree, transport=transport).round_bits()


def joint_omega(omegas) -> float:
    """Lemma 1: the joint operator C = (C_1,...,C_n) has omega =
    max_i omega_i."""
    return max(omegas)
