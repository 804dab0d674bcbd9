"""Mamba-1 (S6 selective state space) mixer — the counterpart of
``repro.models.mamba``.

Prefill and training run the whole sequence through the selective
scan: on a CUDA tensor the hand-written kernels (``kernels/selective_scan``;
under autograd the forward keeps state checkpoints and the backward
kernel gives the scan's gradient), on a CPU tensor the reference's own
route, the chunked scan below, differentiated by autograd as the
reference's is by XLA.  Both compute the same function from a zero
state; they differ in rounding only (the kernel walks the recurrence
step by step, the chunked scan combines decays within a chunk first).
The reference calls its chunked scan on every backend; its Pallas
kernel tiles the same forward on the TPU.

Decode carries (conv window, ssm state) and is O(1) per token.  The port
writes both into the cache tensors IN PLACE (the reference returns a new
``MambaCache``) and returns the same cache object.

On a model axis (``split``, a :class:`repro_torch.core.collective.
ModelSplit`; training only) the mixer runs this process's d_inner block
of E / k channels: ``in_proj_x`` / ``in_proj_z`` / ``conv_*`` /
``dt_proj`` / ``dt_bias`` by columns, ``A_log`` / ``D`` by rows, the
scan on the block's channels; ``x_proj``'s rows give a partial
(dt_low, B, C), summed over the axis (*g*) and entering the block's
products through *f* (every channel reads them, so each process's
gradient of them is partial); ``out_proj``'s rows, then *g*.

Where the numbers differ from the reference's (each pinned by a test):
  * softplus is written as the reference's ``jnp.logaddexp(x, 0)``,
    ``max(x, 0) + log1p(exp(-|x|))``, not ``F.softplus``, whose identity
    above ``threshold=20`` is a different formula (in float32 both round
    to x there);
  * the causal conv is the reference's sum of K shifted products, not
    ``F.conv1d`` (cuDNN: TF32 by default and another order of sums); the
    decode step's window product is the same sum, where the reference
    writes an einsum;
  * the chunked scan's prefix combine is a loop over the chunk's
    positions, not JAX's ``associative_scan`` tree.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.dispatch import use_kernel
from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.models.blocks import dense_init

__all__ = ["init_mamba", "mamba_forward", "mamba_decode_step", "MambaCache",
           "init_mamba_cache", "selective_scan_chunked", "softplus",
           "channels_split"]


def init_mamba(generator, d_model: int, d_state: int = 16, expand: int = 2,
               d_conv: int = 4, dt_rank: Optional[int] = None,
               dtype=torch.float32, *, device) -> dict:
    """The reference's leaves, shapes and init laws, drawn from
    ``generator``: truncated-normal projections, ``A_log = log(1..N)``
    per channel, ``conv_b`` zeros, ``D`` ones, ``dt_bias`` the inverse
    softplus of a log-uniform dt in [0.001, 0.1]."""
    d_inner = expand * d_model
    dt_rank = dt_rank if dt_rank is not None else max(d_model // 16, 1)

    def w(shape, scale=None):
        return dense_init(generator, shape, dtype, device=device, scale=scale)

    A = torch.arange(1, d_state + 1, dtype=torch.float32, device=device)
    u = torch.rand((d_inner,), generator=generator, dtype=torch.float32,
                   device=device)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(0.001))
                        + math.log(0.001))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))   # inverse softplus
    return {
        "in_proj_x": w((d_model, d_inner)),
        "in_proj_z": w((d_model, d_inner)),
        "conv_w": w((d_conv, d_inner), d_conv ** -0.5),
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=device),
        "x_proj": w((d_inner, dt_rank + 2 * d_state)),
        "dt_proj": w((dt_rank, d_inner), dt_rank ** -0.5),
        "dt_bias": dt_bias.to(dtype),
        "A_log": torch.log(A).repeat(d_inner, 1).to(dtype),
        "D": torch.ones((d_inner,), dtype=dtype, device=device),
        "out_proj": w((d_inner, d_model)),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` = max(x, 0) +
    log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, L, Ch), w: (K, Ch)."""
    K, L = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + L, :] * w[i] for i in range(K))
    return out + b


def channels_split(dims: dict) -> bool:
    """Whether the mixer of these cut dims runs on its d_inner block."""
    return dims.get("in_proj_x") is not None


def _ssm_inputs(params: dict, x_conv: torch.Tensor, d_state: int,
                split=None):
    """Shared projection math.  x_conv: (..., d_inner) -> dt, Bm, Cm (in
    x_conv's dtype) and A = -exp(A_log) (float32); on a d_inner block
    (``split``) x_proj's partial product is summed over the axis."""
    dt_rank = params["dt_proj"].shape[0]
    dbc = x_conv @ params["x_proj"]
    if split is not None:
        dbc = split.copy(split.reduce(dbc))
    dt = softplus(dbc[..., :dt_rank] @ params["dt_proj"] + params["dt_bias"])
    Bm = dbc[..., dt_rank:dt_rank + d_state]
    Cm = dbc[..., dt_rank + d_state:]
    A = -torch.exp(params["A_log"].float())
    return dt, Bm, Cm, A


def selective_scan_chunked(dt, Bm, Cm, x, A, h0, chunk: int = 16):
    """S6 scan.  dt / x: (B, L, E), Bm / Cm: (B, L, N), A: (E, N), h0:
    (B, E, N).  Returns (y (B, L, E) float32, h_final (B, E, N)).  Only
    (B, chunk, E, N) tensors are live at any time.  Within a chunk the
    decays and drives are combined by a loop over its positions (the
    reference's ``associative_scan`` combine, applied in order)."""
    L = x.shape[1]
    h = h0.float()
    A = A.float()
    ys = []
    for c0 in range(0, L, chunk):
        sl = slice(c0, min(c0 + chunk, L))
        dtc = dt[:, sl].float()
        decay = torch.exp(dtc[..., None] * A)                       # (B,c,E,N)
        drive = (dtc * x[:, sl].float())[..., None] \
            * Bm[:, sl].float()[:, :, None, :]                      # (B,c,E,N)
        dec_cum, drive_cum = [decay[:, 0]], [drive[:, 0]]
        for t in range(1, decay.shape[1]):
            dec_cum.append(dec_cum[-1] * decay[:, t])
            drive_cum.append(drive_cum[-1] * decay[:, t] + drive[:, t])
        h_all = torch.stack(dec_cum, 1) * h[:, None] \
            + torch.stack(drive_cum, 1)                             # (B,c,E,N)
        ys.append(torch.einsum("bcen,bcn->bce", h_all,
                               Cm[:, sl].float()))
        h = h_all[:, -1]
    return torch.cat(ys, 1), h


def mamba_forward(params: dict, x: torch.Tensor, *, d_state: int = 16,
                  chunk: int = 16, split=None) -> torch.Tensor:
    """Full-sequence forward from a zero state.  x: (B, L, d_model) ->
    (B, L, d_model).  The scan runs the CUDA kernel on a CUDA tensor and
    the chunked scan (``chunk`` positions at a time) on a CPU tensor.
    ``split``: this process's d_inner block of a model axis."""
    if split is not None:
        if channels_split(split.dims):
            x = split.copy(x)
        else:
            params, split = split.whole(params), None
    xi = x @ params["in_proj_x"]
    z = x @ params["in_proj_z"]
    xc = F.silu(_causal_conv1d(xi, params["conv_w"], params["conv_b"]))
    dt, Bm, Cm, A = _ssm_inputs(params, xc, d_state, split)
    if use_kernel(xc):
        y = scan_ops.selective_scan_op(dt, Bm, Cm, xc, A)
    else:
        h0 = torch.zeros((x.shape[0], xc.shape[-1], A.shape[1]),
                         dtype=torch.float32, device=x.device)
        y, _ = selective_scan_chunked(dt, Bm, Cm, xc, A, h0, chunk)
    y = y.to(x.dtype) + params["D"] * xc
    out = (y * F.silu(z)) @ params["out_proj"]
    return out if split is None else split.reduce(out)


class MambaCache(NamedTuple):
    conv: torch.Tensor   # (B, d_conv-1, d_inner) — last K-1 pre-conv inputs
    h: torch.Tensor      # (B, d_inner, N) float32 SSM state


def init_mamba_cache(batch: int, d_inner: int, d_state: int, d_conv: int,
                     dtype, device) -> MambaCache:
    return MambaCache(
        torch.zeros((batch, d_conv - 1, d_inner), dtype=dtype, device=device),
        torch.zeros((batch, d_inner, d_state), dtype=torch.float32,
                    device=device))


def mamba_decode_step(params: dict, x: torch.Tensor, cache: MambaCache, *,
                      d_state: int = 16):
    """One-token step.  x: (B, 1, d_model).  O(1) in context length.
    Returns (out (B, 1, d_model), cache), the cache updated in place."""
    xi = (x @ params["in_proj_x"])[:, 0]                           # (B, E)
    z = (x @ params["in_proj_z"])[:, 0]
    w = params["conv_w"]                                           # (K, E)
    # a new tensor: the shift below copies from it, never within the cache
    window = torch.cat([cache.conv, xi[:, None, :]], dim=1)        # (B, K, E)
    xc = F.silu(sum(window[:, i] * w[i] for i in range(w.shape[0]))
                + params["conv_b"])
    dt, Bm, Cm, A = _ssm_inputs(params, xc, d_state)
    dt = dt.float()
    decay = torch.exp(dt[..., None] * A[None])                     # (B, E, N)
    drive = (dt * xc.float())[..., None] * Bm.float()[:, None, :]
    h = decay * cache.h + drive
    y = torch.sum(h * Cm.float()[:, None, :], dim=-1).to(x.dtype)
    y = y + params["D"] * xc
    out = ((y * F.silu(z)) @ params["out_proj"])[:, None, :]
    cache.conv.copy_(window[:, 1:])
    cache.h.copy_(h)
    return out, cache
