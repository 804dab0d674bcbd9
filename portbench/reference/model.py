"""The plain decoder the cells train, written from the configuration file.

A configuration file names its plain model under ``"reference"``: the
module ``portbench/reference/<reference>.py``, which ``harness.spec.
reference`` loads.  Such a module gives

  MODEL_KEYS          the program's config fields that its model reads;
                      the harness holds the program's config to the file
                      on each of them, and applies a test's size cuts
                      to them alone
  param_shapes(cfg)   one model's leaves, {dotted name: shape}, the
                      names the program's (``a.b.c`` for its nested
                      ``a``/``b``/``c``)
  loss(cfg, params, tokens, half_batch=False)
                      one client's loss on its (B, S) tokens, ``params``
                      one client's leaves by those names; it honours
                      ``cfg["matmul"] == "tf32_emulated"`` (the control:
                      every product's operands rounded to TF32, as
                      ``_mm`` does here) and ``half_batch`` (a planted
                      fault: the mean over the first half of the
                      positions)
  train_flops(cfg, shapes)
                      the analytic FLOPs of one local step of all
                      clients; recomputed forwards are not counted
  weight_std(name, shape)   optional: a leaf's scale, 0 for ones; where
                      it is absent, ``harness.inputs``' rule applies

and imports neither JAX nor anything of the program.

This module's model, ``"reference": "model"``: a layer is ``x +
attn(rmsnorm(x))`` then ``x + ffn(rmsnorm(x))``: grouped-query
attention with rotary positions (the two halves of each head rotated),
a causal softmax in float32; the FFN is a SwiGLU MLP or a token-choice
mixture of experts.  The table is tied: the logits are
the final norm's output times the table's transpose, and the loss is the
mean next-token cross-entropy, plus ``aux_loss_weight`` times the
experts' load-balance loss summed over the layers.

The experts route each sequence's tokens on their own: softmax gates,
the top k by a stable descending sort (the lower expert wins a tie),
the k gates renormalised, and each expert takes at most ``C = max(ceil(
S k / E * capacity_factor), k)`` assignments, counted over the
sequence's first choices before its second ones; an assignment beyond C
adds nothing.  The load-balance loss is ``E * sum_e f_e P_e`` with
``f_e`` the share of assignments and ``P_e`` the mean gate of expert e.

Parameters are client-stacked dicts keyed as ``param_shapes`` gives;
each layer's body is checkpointed, so a backward at 4096 tokens holds
one layer's activations at a time.

FLOPs of one client's training step on B x S tokens (the analytic count
of the repository's ``launch.roofline``, frozen here): 6 N_active a
token for the products (forward 2, backward 4), plus 3 x 4 B S^2 H hd /
2 a layer for the causal attention's score and value products.  N_active
counts the table once (the tied unembedding's product) and k of E
experts a layer.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

MODEL_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab_size", "mixer", "ffn", "n_experts",
              "n_shared_experts", "experts_per_token", "moe_d_ff",
              "capacity_factor", "aux_loss_weight", "rope_theta", "norm_eps",
              "param_dtype", "compute_dtype", "attn_impl", "moe_impl",
              "remat")


def param_shapes(cfg: dict) -> dict:
    """One model's leaves: {dotted name: shape}, layer stacks first on
    their layer axis."""
    L, d, V = cfg["n_layers"], cfg["d_model"], cfg["vocab_size"]
    H, K, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    shapes = {"embed.table": (V, d), "final_norm.scale": (d,),
              "layers.attn.wq": (L, d, H * hd), "layers.attn.wk": (L, d, K * hd),
              "layers.attn.wv": (L, d, K * hd), "layers.attn.wo": (L, H * hd, d),
              "layers.ln1.scale": (L, d), "layers.ln2.scale": (L, d)}
    if cfg["ffn"] == "moe":
        E, f = cfg["n_experts"], cfg["moe_d_ff"]
        shapes.update({"layers.ffn.router": (L, d, E),
                       "layers.ffn.w_gate": (L, E, d, f),
                       "layers.ffn.w_up": (L, E, d, f),
                       "layers.ffn.w_down": (L, E, f, d)})
    else:
        f = cfg["d_ff"]
        shapes.update({"layers.ffn.w_gate": (L, d, f),
                       "layers.ffn.w_up": (L, d, f),
                       "layers.ffn.w_down": (L, f, d)})
    return dict(sorted(shapes.items()))


def _mm(cfg, a, b):
    """``a @ b``; a configuration with ``"matmul": "tf32_emulated"`` first
    rounds both operands to TF32's 10-bit mantissa (the control on a
    machine without TF32)."""
    if cfg.get("matmul") == "tf32_emulated":
        a, b = _tf32(a), _tf32(b)
    return a @ b


def _tf32(t):
    """t rounded to 10 mantissa bits; the gradient passes unchanged."""
    bits = t.detach().contiguous().view(torch.int32)
    return t + (((bits + 0x1000) & ~0x1FFF).view(torch.float32) - t).detach()


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def _rope(x, theta):
    """x: (B, S, heads, hd); the first and second halves of each head are
    the rotated pair."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(cfg, p, h):
    B, S, _ = h.shape
    H, K, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = _rope(_mm(cfg, h, p["wq"]).view(B, S, H, hd), cfg["rope_theta"])
    k = _rope(_mm(cfg, h, p["wk"]).view(B, S, K, hd), cfg["rope_theta"])
    v = _mm(cfg, h, p["wv"]).view(B, S, K, hd)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))        # (B, heads, S, hd)
    k = k.repeat_interleave(H // K, dim=1)
    v = v.repeat_interleave(H // K, dim=1)
    scores = _mm(cfg, q, k.transpose(-1, -2)) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = _mm(cfg, probs, v).transpose(1, 2)
    return _mm(cfg, out.reshape(B, S, H * hd), p["wo"])


def _swiglu(cfg, x, w_gate, w_up, w_down):
    return _mm(cfg, F.silu(_mm(cfg, x, w_gate)) * _mm(cfg, x, w_up), w_down)


def _experts(cfg, p, h):
    """(the routed FFN's output, this layer's load-balance loss)."""
    B, S, d = h.shape
    E, k = cfg["n_experts"], cfg["experts_per_token"]
    C = max(math.ceil(S * k / E * cfg["capacity_factor"]), k)
    gates = torch.softmax(_mm(cfg, h, p["router"]), dim=-1)         # (B, S, E)
    top = torch.sort(gates, dim=-1, descending=True, stable=True).indices[..., :k]
    w = torch.gather(gates, -1, top)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    outs = []
    for b in range(B):
        order = top[b].T.reshape(-1)                 # choice-major: (k * S,)
        weight = w[b].T.reshape(-1)
        token = torch.arange(S, device=h.device).repeat(k)
        onehot = F.one_hot(order, E)
        pos = (torch.cumsum(onehot, 0) - onehot).gather(1, order[:, None])[:, 0]
        kept = pos < C
        out = torch.zeros_like(h[b])
        for e, (wg, wu, wd) in enumerate(zip(p["w_gate"].unbind(0),
                                             p["w_up"].unbind(0),
                                             p["w_down"].unbind(0))):
            sel = kept & (order == e)
            rows = token[sel]
            y = _swiglu(cfg, h[b, rows], wg, wu, wd)
            out = out.index_add(0, rows, y * weight[sel, None])
        outs.append(out)
    f = F.one_hot(top, E).to(torch.float32).sum(2).mean(1)          # (B, E)
    P = gates.mean(1)
    return torch.stack(outs), torch.mean(torch.sum(f * P, -1)) * E


def _layer(cfg, x, *leaves):
    p = dict(zip(_LAYER_KEYS[cfg["ffn"]], leaves))
    eps = cfg["norm_eps"]
    x = x + _attention(cfg, p, _rmsnorm(x, p["ln1"], eps))
    h = _rmsnorm(x, p["ln2"], eps)
    if cfg["ffn"] == "moe":
        y, aux = _experts(cfg, p, h)
        return x + y, aux
    return x + _swiglu(cfg, h, p["w_gate"], p["w_up"], p["w_down"]), \
        torch.zeros((), device=x.device)


_LAYER_KEYS = {
    "dense": ("wq", "wk", "wv", "wo", "ln1", "ln2", "w_gate", "w_up", "w_down"),
    "moe": ("wq", "wk", "wv", "wo", "ln1", "ln2", "w_gate", "w_up", "w_down",
            "router"),
}
_LEAF = {"wq": "layers.attn.wq", "wk": "layers.attn.wk", "wv": "layers.attn.wv",
         "wo": "layers.attn.wo", "ln1": "layers.ln1.scale",
         "ln2": "layers.ln2.scale", "w_gate": "layers.ffn.w_gate",
         "w_up": "layers.ffn.w_up", "w_down": "layers.ffn.w_down",
         "router": "layers.ffn.router"}


def loss(cfg: dict, params: dict, tokens: torch.Tensor,
         half_batch: bool = False) -> torch.Tensor:
    """One client's loss on its (B, S) tokens; ``params`` maps the names
    of ``param_shapes`` to one client's tensors.  ``half_batch`` (a
    planted fault) takes the mean over the first half of the positions."""
    table = params["embed.table"]
    x = table[tokens.long()]
    aux = torch.zeros((), device=x.device)
    stacks = [params[_LEAF[n]].unbind(0) for n in _LAYER_KEYS[cfg["ffn"]]]
    for i in range(cfg["n_layers"]):
        x, a = checkpoint(_layer, cfg, x, *(s[i] for s in stacks),
                          use_reentrant=False)
        aux = aux + a
    x = _rmsnorm(x, params["final_norm.scale"], cfg["norm_eps"])
    logits = _mm(cfg, x, table.T)
    targets = tokens[:, 1:].long()
    logits = logits[:, :-1]
    if half_batch:
        half = logits.shape[1] // 2
        logits, targets = logits[:, :half], targets[:, :half]
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))
    return ce + cfg["aux_loss_weight"] * aux


def active_params(cfg: dict, shapes: dict) -> float:
    total = 0.0
    for name, shape in shapes.items():
        size = math.prod(shape)
        if cfg["ffn"] == "moe" and name in ("layers.ffn.w_gate",
                                            "layers.ffn.w_up",
                                            "layers.ffn.w_down"):
            size = size * cfg["experts_per_token"] / cfg["n_experts"]
        total += size
    return total


def train_flops(cfg: dict, shapes: dict) -> float:
    """FLOPs of one local step of all clients."""
    B, S = cfg["batch_per_client"], cfg["seq_len"]
    attention = cfg["n_layers"] * 4.0 * B * S * S * cfg["n_heads"] \
        * cfg["head_dim"] * 0.5
    per_client = 6.0 * active_params(cfg, shapes) * B * S + 3.0 * attention
    return cfg["clients"] * per_client
