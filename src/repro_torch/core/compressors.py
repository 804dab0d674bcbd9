"""Compressors (the paper's §IV-A) — the counterpart of
``repro.core.compressors`` for this slice of the port: :class:`Identity`
and :class:`QSGD`.

Each compressor is a Codec: ``encode(key, x) -> payload``,
``decode(payload) -> x`` and ``apply(key, x)``.  Identity implements all
three per leaf (its dense payload is what the leafwise transport
carries).  QSGD runs through the flat-buffer engine
(:mod:`repro_torch.core.flatbuf`, one fused kernel per tree); its
per-leaf codec and the other compressors of the reference — natural,
terngrad, bernoulli, rand-k, top-k — are later slices (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.codec import DensePayload

__all__ = ["Compressor", "Identity", "QSGD", "make_compressor"]

_LATER = {"natural", "terngrad", "bernoulli", "randk", "topk"}


def _nelem(shape) -> int:
    return int(np.prod(shape)) if len(shape) else 1


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Base class / Codec protocol."""

    name: str = dataclasses.field(default="base", init=False)

    def encode(self, key, x: torch.Tensor):
        raise NotImplementedError(
            f"per-leaf {self.name!r} encode is slice 2 of the port "
            "(ROADMAP.md); use the flat or packed transport")

    def decode(self, payload) -> torch.Tensor:
        raise NotImplementedError(
            f"per-leaf {self.name!r} decode is slice 2 of the port "
            "(ROADMAP.md); use the flat or packed transport")

    def apply(self, key, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(key, x))

    def omega(self, shape) -> float:
        """Variance factor omega (Assumption 1)."""
        raise NotImplementedError

    def wire_bits(self, shape) -> float:
        """Information-theoretic wire width (a lower bound for theory
        tables; the ledger charges ``CompressionPlan.round_bits()``)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Identity(Compressor):
    """No compression: omega = 0, 32 bits/element (DensePayload)."""

    name: str = dataclasses.field(default="identity", init=False)

    def encode(self, key, x):
        return DensePayload(values=x.reshape(-1).to(torch.float32),
                            shape=tuple(x.shape), dtype=x.dtype)

    def decode(self, payload):
        return payload.values.reshape(payload.shape).to(payload.dtype)

    def apply(self, key, x):
        return x.to(torch.float32).to(x.dtype)

    def omega(self, shape) -> float:
        return 0.0

    def wire_bits(self, shape) -> float:
        return 32.0 * _nelem(shape)


@dataclasses.dataclass(frozen=True)
class QSGD(Compressor):
    """QSGD / random dithering [Alistarh et al. 2017] with ``levels``
    levels per bucket of ``bucket`` elements; its wire message is
    :class:`~repro_torch.core.codec.QSGDPayload`."""

    levels: int = 127
    bucket: int = 2048
    name: str = dataclasses.field(default="qsgd", init=False)

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


_REGISTRY = {"identity": Identity, "qsgd": QSGD}


def make_compressor(name: str, **kwargs) -> Compressor:
    """Factory: ``make_compressor('qsgd', levels=15)``."""
    if name in _LATER:
        raise NotImplementedError(
            f"compressor {name!r} is not ported yet; see ROADMAP.md for "
            "the slice that brings it")
    if name not in _REGISTRY:
        raise ValueError(f"unknown compressor {name!r}; have "
                         f"{sorted(_REGISTRY) + sorted(_LATER)}")
    return _REGISTRY[name](**kwargs)
