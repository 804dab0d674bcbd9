"""Selective scan — the wrapper of the CUDA kernel in
``csrc/selective_scan.cu``, the counterpart of
``repro.kernels.selective_scan.kernel.selective_scan``.

The kernel takes dt, x (B, L, E) and Bm, Cm (B, L, N), contiguous, in
float32 or bfloat16 (all four alike), A (E, N) contiguous float32, any
L >= 1, any E >= 1 and N <= :data:`MAX_STATE`, and writes a contiguous
(B, L, E) y in x.dtype.  The state starts at zero, as in the reference's
kernel.  The reference's ``chunk`` and ``e_blk`` sized its tiles to VMEM
(and made callers pad L); the CUDA kernel masks its own edges and has
no such knobs.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
plain version in ``ref.py``.  Like the reference's Pallas kernel, the
CUDA op has no backward.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.dispatch import use_kernel
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

__all__ = ["LANES", "MAX_STATE", "lane_split", "warps", "selective_scan"]

#: the largest state size N the kernel keeps in registers
MAX_STATE = 16

#: lanes of a warp a channel's states are spread over, at most (kLanes in
#: the source)
LANES = 8


def lane_split(N: int) -> tuple:
    """(lanes a channel, states a lane) at state size N, as ``Split<N>``
    in the source: the power of two at or above N, at most
    :data:`LANES`, and the states shared out over them."""
    lanes = min(LANES, 1 << (N - 1).bit_length())
    return lanes, -(-N // lanes)


def warps(B: int, E: int, N: int) -> int:
    """Warps a launch runs: blocks of 128 threads, 128 / lanes channels
    each, over B batch rows."""
    return B * -(-E // (128 // lane_split(N)[0])) * 4


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(dt, Bm, Cm, x, A) -> None:
    if x.dim() != 3 or dt.shape != x.shape or Bm.dim() != 3 \
            or Cm.shape != Bm.shape or Bm.shape[:2] != x.shape[:2]:
        raise ValueError(f"expected dt, x (B, L, E) and Bm, Cm (B, L, N), got "
                         f"{tuple(dt.shape)}, {tuple(x.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    N = Bm.shape[2]
    if A.shape != (x.shape[2], N):
        raise ValueError(f"A must be (E, N) = {(x.shape[2], N)}, got "
                         f"{tuple(A.shape)}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"state size N = {N} outside 1..{MAX_STATE}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (dt, Bm, Cm)):
        raise ValueError(f"dt, Bm, Cm, x must share float32 or bfloat16, got "
                         f"{dt.dtype}, {Bm.dtype}, {Cm.dtype}, {x.dtype}")
    if A.dtype != torch.float32:
        raise ValueError(f"A must be float32, got {A.dtype}")
    for t, what in ((dt, "dt"), (Bm, "Bm"), (Cm, "Cm"), (x, "x"), (A, "A")):
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")


def _launch(dt, Bm, Cm, x, A) -> torch.Tensor:
    Bsz, L, E = x.shape
    if Bsz > 65535:
        raise ValueError(f"batch {Bsz} exceeds the grid's 65535")
    y = torch.empty((Bsz, L, E), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    dispatch.launch("selective_scan", "selective_scan", _SIGNATURE, x.device,
                    dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), x.data_ptr(),
                    A.data_ptr(), y.data_ptr(), _DTYPES[x.dtype], Bsz, L, E,
                    Bm.shape[2])
    return y


class _SelectiveScan(torch.autograd.Function):
    """The CUDA op.  Forward only, as the reference's Pallas kernel."""

    @staticmethod
    def forward(ctx, dt, Bm, Cm, x, A):
        return _launch(dt, Bm, Cm, x, A)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "the selective-scan kernel has no backward (nor has the "
            "reference's Pallas kernel, whose training path differentiates "
            "the chunked scan of models/mamba.py)")


def selective_scan(dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                   x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """dt / x: (B, L, E); Bm / Cm: (B, L, N); A: (E, N) float32.  Returns
    y (B, L, E) in x.dtype, from a zero state."""
    _check(dt, Bm, Cm, x, A)
    if not use_kernel(dt, Bm, Cm, x, A):
        return selective_scan_ref(dt, Bm, Cm, x, A)
    return _SelectiveScan.apply(dt, Bm, Cm, x, A)
