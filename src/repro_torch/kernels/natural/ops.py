"""Single-array natural compression and the server's fused decode->reduce
— the counterparts of ``repro.kernels.natural.ops``.

``natural_reduce`` wraps the ``natural_reduce`` CUDA kernel.  It consumes
a STACKED natural wire batch — exponent codes (n, n_buckets, bucket)
uint8 plus packed sign bitmaps (n, n_buckets, bucket // 8) uint8 — and
accumulates the weighted sum of the reconstructed buffers
(``bitcast((sign << 31) | (exp << 23))``) in client order 0..n-1 into one
(n_buckets, bucket) float32 buffer: server memory is O(d), not O(n*d)
(DESIGN.md §10).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import use_kernel
from repro_torch.kernels.natural.kernel import (check_aligned, check_wire,
                                                launch, natural_fused)
from repro_torch.kernels.natural.ref import natural_reduce_ref

__all__ = ["natural_compress", "natural_reduce"]

_LANE = 128


def natural_compress(key, x: torch.Tensor) -> torch.Tensor:
    """Natural compression of one array of any shape: lane-padded to
    (n_buckets, 128), one fused launch, cut back; dtype preserved."""
    from repro_torch.core.flatbuf import bucketize, seeds_of, unbucketize
    flat = x.reshape(-1)
    x2d = bucketize(flat.to(torch.float32), _LANE).contiguous()
    out = natural_fused(x2d, seeds_of(key))
    return unbucketize(out, flat.shape[0]).reshape(x.shape).to(x.dtype)


def natural_reduce(exps: torch.Tensor, signs: torch.Tensor,
                   weights=None) -> torch.Tensor:
    """Weighted sum of the reconstructed payloads over the leading client
    axis; ``weights`` is an optional (n,) float32 vector."""
    check_wire(exps, torch.uint8, 3, "exps")
    n, nb, b = exps.shape
    if b % 8 or signs.shape != (n, nb, b // 8):
        raise ValueError(f"signs {tuple(signs.shape)} do not match exps "
                         f"{tuple(exps.shape)} (8 signs per byte)")
    check_wire(signs, torch.uint8, 3, "signs")
    operands = (exps, signs)
    if weights is not None:
        if weights.shape != (n,) or weights.dtype != torch.float32:
            raise ValueError(f"weights must be float32 ({n},), got "
                             f"{weights.dtype} {tuple(weights.shape)}")
        weights = weights.contiguous()
        operands = operands + (weights,)
    if not use_kernel(*operands):
        return natural_reduce_ref(exps, signs, weights)
    out = torch.empty((nb, b), dtype=torch.float32, device=exps.device)
    if out.numel() and n:
        check_aligned(exps, "exps", 4)
        launch("natural_reduce", exps.device, exps.data_ptr(),
               signs.data_ptr(),
               0 if weights is None else weights.data_ptr(), out.data_ptr(),
               n, nb * b)
    elif out.numel():
        out.zero_()
    return out
