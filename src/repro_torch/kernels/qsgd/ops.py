"""Single-array QSGD compression and the server's fused decode->reduce
— the counterparts of ``repro.kernels.qsgd.ops``.

``qsgd_compress`` pads and buckets through the flat engine's bucketizer
(:func:`repro_torch.core.flatbuf.bucketize`) and runs ``qsgd_fused`` on
the key's seed words: the noise is drawn in the kernel.

``qsgd_reduce`` wraps the ``qsgd_reduce`` CUDA kernel.  It consumes a STACKED payload batch — codes (n, n_buckets, bucket) int8
plus norms (n, n_buckets, 1) — and accumulates ``sum_i w_i * codes_i *
(norms_i / s)`` in client order 0..n-1 into one (n_buckets, bucket)
float32 buffer, never materializing a per-client dequantized buffer:
server memory is O(d), not O(n*d) (DESIGN.md §10).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import use_kernel
from repro_torch.kernels.qsgd.kernel import check_levels, launch, qsgd_fused
from repro_torch.kernels.qsgd.ref import qsgd_reduce_ref

__all__ = ["qsgd_compress", "qsgd_reduce"]


def qsgd_compress(key, x: torch.Tensor, *, levels: int = 127,
                  bucket: int = 2048) -> torch.Tensor:
    """Quantize-dequantize an array of any shape (compressor semantics):
    bucketized float32, one fused launch, cut back; dtype preserved."""
    from repro_torch.core.flatbuf import bucketize, seeds_of, unbucketize
    flat = x.reshape(-1)
    x2d = bucketize(flat.to(torch.float32), bucket).contiguous()
    out = qsgd_fused(x2d, seeds_of(key), levels=levels)
    return unbucketize(out, flat.shape[0]).reshape(x.shape).to(x.dtype)


def qsgd_reduce(codes: torch.Tensor, norms: torch.Tensor, weights=None, *,
                levels: int = 127) -> torch.Tensor:
    """Weighted sum of the dequantized payloads over the leading client
    axis; ``weights`` is an optional (n,) float32 vector."""
    check_levels(levels)
    if codes.dtype != torch.int8 or codes.dim() != 3 \
            or not codes.is_contiguous():
        raise ValueError(f"codes must be contiguous int8 (n, nb, b), got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    n, nb, b = codes.shape
    if norms.shape != (n, nb, 1) or norms.dtype != torch.float32 \
            or not norms.is_contiguous():
        raise ValueError(f"norms must be contiguous float32 {(n, nb, 1)}, "
                         f"got {norms.dtype} {tuple(norms.shape)}")
    operands = (codes, norms)
    if weights is not None:
        if weights.shape != (n,) or weights.dtype != torch.float32:
            raise ValueError(f"weights must be float32 ({n},), got "
                             f"{weights.dtype} {tuple(weights.shape)}")
        weights = weights.contiguous()
        operands = operands + (weights,)
    if not use_kernel(*operands):
        return qsgd_reduce_ref(codes, norms, weights, levels=levels)
    out = torch.empty((nb, b), dtype=torch.float32, device=codes.device)
    if out.numel() and n:
        launch("qsgd_reduce", codes.device, codes.data_ptr(),
               norms.data_ptr(), 0 if weights is None else weights.data_ptr(),
               out.data_ptr(), n, nb, b, int(levels))
    elif out.numel():
        out.zero_()
    return out
