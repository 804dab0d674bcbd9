"""Shared building blocks: norms, RoPE, MLPs, embeddings, the loss — the
counterparts of ``repro.models.blocks``.

Everything is functional: ``init_*`` returns a parameter dict, and the
apply functions take (params, x).  Layer params are stacked over a
leading layer axis by :mod:`repro_torch.models.model`, as the reference
stacks them for its scan.

On a model axis (``split``, a :class:`repro_torch.core.collective.
ModelSplit`; the 2-D engine's Megatron split) the MLP runs its gate / up
columns and its down rows of this process's d_ff block, and the table's
vocab block gives the embedding rows of its vocab range, a vocab block
of the logits, and the loss over the blocks (the global max and the sum
of exponentials over the axis in rank order, the target's logit from
the block that holds it).  A leaf the axis leaves whole runs the plain
path.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["dense_init", "init_rmsnorm", "rmsnorm", "rope_frequencies",
           "apply_rope", "init_mlp", "mlp", "init_embedding", "embed",
           "unembed", "sinusoidal_positions", "sinusoidal_position_at",
           "cross_entropy_loss", "mlp_splits"]


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


def mlp_splits(dims: dict) -> bool:
    """Whether the MLP of these cut dims runs on its d_ff block: gate and
    up cut on their columns (a fused ``w_in`` block would hold gate
    columns on one process and up columns on another: it is gathered)."""
    return dims.get("w_gate") is not None


def mlp(params: dict, x: torch.Tensor, activation: str = "silu",
        split=None) -> torch.Tensor:
    act = _activation(activation)
    if split is not None:
        if mlp_splits(split.dims):
            h = split.copy(x)
            gate = act(h @ params["w_gate"])
            return split.reduce((gate * (h @ params["w_up"]))
                                @ params["w_down"])
        params = split.whole(params)
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


def _vocab_block(split):
    """The split of a table cut on its vocab rows over more than one
    process, else None."""
    return split if split is not None and split.size > 1 \
        and split.dim("table") is not None else None


def _in_block(ids: torch.Tensor, lo: int, n: int):
    """(ids - lo clamped into the block's rows, whether each id lies in
    [lo, lo + n))."""
    local = ids.long() - lo
    inside = (local >= 0) & (local < n)
    return torch.where(inside, local, 0), inside


def embed(params: dict, tokens: torch.Tensor, split=None) -> torch.Tensor:
    """The table's rows of ``tokens``; on a vocab block each process
    looks up the tokens of its vocab range, zeros elsewhere, and the
    blocks are summed (one of them is non-zero: exact)."""
    table = params["table"]
    if _vocab_block(split) is None:
        return table[tokens]
    rows = table.shape[0]
    local, inside = _in_block(tokens, split.index * rows, rows)
    return split.reduce(torch.where(inside[..., None], table[local], 0.0))


def unembed(params: dict, x: torch.Tensor, split=None) -> torch.Tensor:
    """Tied LM head: logits = x @ table^T (computed in fp32); on a vocab
    block, this block's columns of the logits (B, S, V / k)."""
    if _vocab_block(split) is not None:
        x = split.copy(x)
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
                       mask: Optional[torch.Tensor] = None,
                       split=None) -> torch.Tensor:
    """Mean token cross-entropy in fp32.  logits: (..., V), labels int.
    With ``split`` (the table's, cut on its vocab rows) the logits are
    this process's vocab block (..., V / k): the max, the sum of
    exponentials and the target's logit are taken over the blocks."""
    logits = logits.float()
    if _vocab_block(split) is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    else:
        n = logits.shape[-1]
        top = split.max(logits.amax(dim=-1))
        local, inside = _in_block(labels, split.index * n, n)
        own = torch.gather(logits, -1, local[..., None])[..., 0]
        sums = split.reduce(torch.stack([
            torch.sum(torch.exp(logits - top[..., None]), dim=-1),
            torch.where(inside, own, 0.0)]))
        logz, gold = top + torch.log(sums[0]), sums[1]
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
