"""Bit packing and float32 bit views — the tensor half of
``repro.core.codec``'s ``pack_bits`` / ``unpack_bits`` / ``natural_split``
/ ``natural_merge``, kept here (below the codec layer) so that the
natural kernels' plain versions can use them without an import cycle.

  pack_bits / unpack_bits      — fields of width 1, 2 or 4 bits, packed
                                 little-endian within the byte: at width
                                 1, bit j of byte k is field 8k + j
  natural_split / natural_merge — the 9 wire bits of a natural-compression
                                 output (uint8 biased exponent + 0/1 sign)
  float_bits / bits_float      — float32 <-> its uint32 bit pattern held in
                                 an int64 tensor (torch's CPU ``uint32``
                                 lacks ``+``, ``>>`` and ``<``)

Packing stays in ``uint8``, as the reference does: the shifted fields of
one byte are disjoint, so their byte sum is their bitwise or.
"""
from __future__ import annotations

import torch

__all__ = ["pack_bits", "unpack_bits", "natural_split", "natural_merge",
           "float_bits", "bits_float"]

_MASK = 0xFFFFFFFF


def _per_byte(width: int) -> int:
    if width not in (1, 2, 4):
        raise ValueError(f"field width {width} does not divide a byte "
                         "(have 1, 2, 4)")
    return 8 // width


def pack_bits(fields: torch.Tensor, width: int) -> torch.Tensor:
    """Pack fields (< 2**width) along the last axis into uint8 bytes,
    little-endian within the byte; the last axis must be a multiple of
    ``8 // width``."""
    per = _per_byte(width)
    b = fields.to(torch.uint8).reshape(tuple(fields.shape[:-1]) + (-1, per))
    shifts = torch.arange(per, dtype=torch.uint8, device=fields.device) \
        * width
    return torch.sum(b << shifts, dim=-1, dtype=torch.uint8)


def unpack_bits(packed: torch.Tensor, width: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: the fields as uint8 (the reference
    widens them to uint32; every field here fits a byte)."""
    per = _per_byte(width)
    shifts = torch.arange(per, dtype=torch.uint8, device=packed.device) \
        * width
    out = (packed.to(torch.uint8)[..., None] >> shifts) & ((1 << width) - 1)
    return out.reshape(tuple(packed.shape[:-1]) + (-1,))


def natural_split(y: torch.Tensor):
    """(uint8 biased-exponent codes, uint8 0/1 signs) of float32 values
    with zero mantissa (the output of natural compression)."""
    bits = y.to(torch.float32).contiguous().view(torch.int32)
    exps = ((bits >> 23) & 0xFF).to(torch.uint8)
    signs = ((bits >> 31) & 1).to(torch.uint8)
    return exps, signs


def natural_merge(exps: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`natural_split`: ``bitcast((sign << 31) | (exp <<
    23))``, composed in int32 (``1 << 31`` is the pattern 0x80000000)."""
    bits = (signs.to(torch.int32) << 31) | (exps.to(torch.int32) << 23)
    return bits.view(torch.float32)


def float_bits(x: torch.Tensor) -> torch.Tensor:
    """The uint32 bit patterns of float32 ``x``, as int64 in [0, 2^32)."""
    return x.to(torch.float32).contiguous().view(torch.int32) \
        .to(torch.int64) & _MASK


def bits_float(bits: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`float_bits` for int64 patterns in [0, 2^32)."""
    signed = bits - ((bits >> 31) << 32)
    return signed.to(torch.int32).view(torch.float32)
