"""Entry point of the selective scan — the counterpart of
``repro.kernels.selective_scan.ops``.

The reference's op padded L to its chunk and halved ``e_blk`` until it
divided E, because its Pallas kernel asserts both; the CUDA kernel takes
any L and E, so this op only hands it contiguous operands (the Mamba
mixer's B and C are column slices of one projection).
"""
from __future__ import annotations

from repro_torch.kernels.selective_scan.kernel import selective_scan

__all__ = ["selective_scan_op"]


def selective_scan_op(dt, Bm, Cm, x, A):
    """dt / x: (B, L, E); Bm / Cm: (B, L, N); A: (E, N).  Returns
    y (B, L, E) in x.dtype, from a zero state."""
    return selective_scan(dt.contiguous(), Bm.contiguous(), Cm.contiguous(),
                          x.contiguous(), A.contiguous())
