"""Shared building blocks: norms, RoPE, MLPs, embeddings, the loss — the
counterparts of ``repro.models.blocks``.

Everything is functional: ``init_*`` returns a parameter dict, and the
apply functions take (params, x).  Layer params are stacked over a
leading layer axis by :mod:`repro_torch.models.model`, as the reference
stacks them for its scan.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["dense_init", "init_rmsnorm", "rmsnorm", "rope_frequencies",
           "apply_rope", "init_mlp", "mlp", "init_embedding", "embed",
           "unembed", "sinusoidal_positions", "sinusoidal_position_at",
           "cross_entropy_loss"]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(generator: Optional[torch.Generator], shape, dtype, *,
               device, scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init: a standard normal cut to [-2, 2],
    times ``scale`` (default fan_in ** -0.5), drawn from ``generator``.
    The values differ from ``jax.random.truncated_normal``'s; parity
    tests carry the reference's weights across instead.  On the ``meta``
    device only the shape exists (no generator needed)."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    out = torch.empty(shape, dtype=torch.float32, device=device)
    if out.device.type != "meta":
        torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        out.mul_(std)
    return out.to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * params["scale"].float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE (half-split, as the reference's jnp.split(x, 2, -1))
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integer."""
    hd = x.shape[-1]
    inv = rope_frequencies(hd, theta, x.device)              # (hd/2,)
    ang = positions[..., None].float() * inv                 # (..., seq, hd/2)
    cos = torch.cos(ang)[..., None, :]                       # over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def init_mlp(generator, d_model: int, d_ff: int, dtype, *, device,
             fused: bool = False) -> dict:
    if fused:
        return {
            "w_in": dense_init(generator, (d_model, 2 * d_ff), dtype,
                               device=device),
            "w_down": dense_init(generator, (d_ff, d_model), dtype,
                                 device=device),
        }
    return {
        "w_gate": dense_init(generator, (d_model, d_ff), dtype, device=device),
        "w_up": dense_init(generator, (d_model, d_ff), dtype, device=device),
        "w_down": dense_init(generator, (d_ff, d_model), dtype, device=device),
    }


def _activation(name: str):
    if name == "silu":
        return F.silu
    # jax.nn.gelu defaults to the tanh approximation
    return lambda t: F.gelu(t, approximate="tanh")


def mlp(params: dict, x: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    act = _activation(activation)
    if "w_in" in params:
        gate, up = torch.chunk(x @ params["w_in"], 2, dim=-1)
        return (act(gate) * up) @ params["w_down"]
    gate = act(x @ params["w_gate"])
    return (gate * (x @ params["w_up"])) @ params["w_down"]


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def init_embedding(generator, vocab: int, d_model: int, dtype, *,
                   device) -> dict:
    return {"table": dense_init(generator, (vocab, d_model), dtype,
                                device=device, scale=0.02)}


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied LM head: logits = x @ table^T (computed in fp32)."""
    return x.float() @ params["table"].float().T


# ---------------------------------------------------------------------------
# Sinusoidal positions (the encoder-decoder's)
# ---------------------------------------------------------------------------

def _sinusoid(pos: torch.Tensor, d_model: int) -> torch.Tensor:
    """[sin(ang), cos(ang)] with ang = pos / 10000 ** (2 dim / d_model),
    float32 positions (...,) -> (..., d_model).  The angle is the
    float32 quotient, as the reference's; its power of 10000 and the
    sine and cosine are taken in float64 and rounded once, which gives
    the reference's table (constant-folded by XLA) within an ulp at
    4096 positions; float32 ``pow`` alone is 1.2e-4 away there
    (tests/test_torch_encdec.py)."""
    dim = torch.arange(d_model // 2, dtype=torch.float32, device=pos.device)
    den = (10000.0 ** (2.0 * dim / d_model).double()).float()
    ang = (pos[..., None] / den).double()
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).float()


def sinusoidal_positions(length: int, d_model: int,
                         device=None) -> torch.Tensor:
    """Whisper-style sinusoidal position embeddings (length, d_model)."""
    return _sinusoid(torch.arange(length, dtype=torch.float32,
                                  device=device), d_model)


def sinusoidal_position_at(index: int, d_model: int,
                           device=None) -> torch.Tensor:
    """Row ``index`` of :func:`sinusoidal_positions`, (d_model,)."""
    return _sinusoid(torch.tensor(float(index), dtype=torch.float32,
                                  device=device), d_model)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy in fp32.  logits: (..., V), labels int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
