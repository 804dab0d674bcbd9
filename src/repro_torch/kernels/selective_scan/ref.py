"""Plain PyTorch version of the selective-scan kernel — the counterpart
of ``repro.kernels.selective_scan.ref``: the sequential S6 recurrence,
one time step at a time, with the state in float32.

Its order of operations is the CUDA kernel's: ``decay = exp(dt·A)``,
``drive = (dt·x)·B``, ``h = decay·h + drive`` (each product and the sum
rounded on its own), ``y = Σ_n h·C``; y is cast to ``x.dtype``.
"""
from __future__ import annotations

import torch

__all__ = ["selective_scan_ref"]


def selective_scan_ref(dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                       x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """dt / x: (B, L, E); Bm / Cm: (B, L, N); A: (E, N) -> y (B, L, E)
    in x.dtype.  The state starts at zero."""
    Bsz, L, E = x.shape
    dt, Bm, Cm, xf = dt.float(), Bm.float(), Cm.float(), x.float()
    A = A.float()
    h = torch.zeros((Bsz, E, A.shape[1]), dtype=torch.float32,
                    device=x.device)
    ys = torch.empty((Bsz, L, E), dtype=torch.float32, device=x.device)
    for t in range(L):
        dt_t = dt[:, t]
        decay = torch.exp(dt_t[..., None] * A[None])            # (B, E, N)
        drive = (dt_t * xf[:, t])[..., None] * Bm[:, t, None, :]
        h = decay * h + drive
        ys[:, t] = torch.sum(h * Cm[:, t, None, :], dim=-1)
    return ys.to(x.dtype)
