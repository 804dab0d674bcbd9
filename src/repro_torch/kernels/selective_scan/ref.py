"""Plain PyTorch version of the selective-scan kernels — the counterpart
of ``repro.kernels.selective_scan.ref``: the sequential S6 recurrence,
one time step at a time, with the state in float32, and its backward.

Its order of operations is the CUDA kernels': ``decay = exp(dt·A)``,
``drive = (dt·x)·B``, ``h = decay·h + drive`` (each product and the sum
rounded on its own), ``y = Σ_n h·C``; y is cast to ``x.dtype``.  The
backward walks the same recurrence in reverse (see
:func:`selective_scan_bwd_ref`).
"""
from __future__ import annotations

import torch

__all__ = ["selective_scan_ref", "selective_scan_bwd_ref"]


def _step(h, dt_t, x_t, B_t, A):
    """One step of the recurrence: (B, E, N) state -> (B, E, N) state."""
    decay = torch.exp(dt_t[..., None] * A[None])                # (B, E, N)
    drive = (dt_t * x_t)[..., None] * B_t[:, None, :]
    return decay * h + drive


def selective_scan_ref(dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                       x: torch.Tensor, A: torch.Tensor,
                       ckpt_chunk: int | None = None):
    """dt / x: (B, L, E); Bm / Cm: (B, L, N); A: (E, N) -> y (B, L, E)
    in x.dtype.  The state starts at zero.  With ``ckpt_chunk`` it
    returns (y, h_ckpt): h_ckpt (B, ceil(L / ckpt_chunk), E, N) float32
    holds the state before step k·ckpt_chunk, as the CUDA kernel writes
    it for the backward."""
    Bsz, L, E = x.shape
    dt, Bm, Cm, xf = dt.float(), Bm.float(), Cm.float(), x.float()
    A = A.float()
    h = torch.zeros((Bsz, E, A.shape[1]), dtype=torch.float32,
                    device=x.device)
    ys = torch.empty((Bsz, L, E), dtype=torch.float32, device=x.device)
    ckpts = []
    for t in range(L):
        if ckpt_chunk is not None and t % ckpt_chunk == 0:
            ckpts.append(h)
        h = _step(h, dt[:, t], xf[:, t], Bm[:, t], A)
        ys[:, t] = torch.sum(h * Cm[:, t, None, :], dim=-1)
    if ckpt_chunk is None:
        return ys.to(x.dtype)
    h_ckpt = torch.stack(ckpts, 1) if ckpts else torch.zeros(
        (Bsz, 0, E, A.shape[1]), dtype=torch.float32, device=x.device)
    return ys.to(x.dtype), h_ckpt


def selective_scan_bwd_ref(dt, Bm, Cm, x, A, h_ckpt, grad, ckpt_chunk: int,
                           return_carries: bool = False):
    """The gradient of the recurrence, float32: given the forward's
    operands, its checkpoints ``h_ckpt`` (every ``ckpt_chunk`` steps) and
    ``grad`` = dL/dy (B, L, E), returns (ddt, dBm, dCm, dx, dA) shaped as
    dt, Bm, Cm, x, A; with ``return_carries`` also the carry each chunk's
    reverse walk starts from, (B, chunks, E, N) (zero for the last: what
    the backward kernel's carry pass writes).  For each chunk, last
    first, the states are recomputed from its checkpoint, then walked
    backwards:

      dh_t    = g_t·C_t + carry             (carry = decay_{t+1}·dh_{t+1})
      dprod   = (dh_t·h_{t-1})·decay_t      (the gradient of dt_t·A)
      ddt_t   = Σ_n dprod·A + x_t·Σ_n dh_t·B_t
      dx_t    = dt_t·Σ_n dh_t·B_t
      dA      = Σ_b Σ_t dprod·dt_t          (t from L-1 down, b in order)
      dB_t    = Σ_e dh_t·(dt_t·x_t),  dC_t = Σ_e g_t·h_t

    with the kernel's roundings; the sums over n and e run in torch's
    order (the kernel's trees differ from it in the last bits), and the
    kernel sums dA over each chunk's steps and then over (b, chunk)."""
    Bsz, L, E = x.shape
    N = A.shape[1]
    ddt = torch.empty((Bsz, L, E), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(ddt)
    dB = torch.empty((Bsz, L, N), dtype=torch.float32, device=x.device)
    dC = torch.empty_like(dB)
    dA = torch.zeros((Bsz, E, N), dtype=torch.float32, device=x.device)
    carry = torch.zeros((Bsz, E, N), dtype=torch.float32, device=x.device)
    carries = torch.empty_like(h_ckpt) if return_carries else None
    for k in reversed(range(h_ckpt.shape[1])):
        t0, t1 = k * ckpt_chunk, min(L, (k + 1) * ckpt_chunk)
        if return_carries:
            carries[:, k] = carry
        hs = [h_ckpt[:, k]]
        for t in range(t0, t1):
            hs.append(_step(hs[-1], dt[:, t], x[:, t], Bm[:, t], A))
        for t in reversed(range(t0, t1)):
            dt_t, x_t, g_t = dt[:, t], x[:, t], grad[:, t]
            dh = g_t[..., None] * Cm[:, t, None, :] + carry
            decay = torch.exp(dt_t[..., None] * A[None])
            dprod = (dh * hs[t - t0]) * decay
            dA = dA + dprod * dt_t[..., None]
            dbx = torch.sum(dh * Bm[:, t, None, :], dim=-1)
            ddt[:, t] = torch.sum(dprod * A[None], dim=-1) + x_t * dbx
            dx[:, t] = dt_t * dbx
            dB[:, t] = torch.sum(dh * (dt_t * x_t)[..., None], dim=1)
            dC[:, t] = torch.sum(g_t[..., None] * hs[t - t0 + 1], dim=1)
            carry = decay * dh
    total = dA[0]
    for b in range(1, Bsz):
        total = total + dA[b]
    if return_carries:
        return ddt, dB, dC, dx, total, carries
    return ddt, dB, dC, dx, total
