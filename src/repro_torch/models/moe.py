"""Mixture-of-Experts FFN with token-choice top-k routing — the
counterpart of ``repro.models.moe``.

Two dispatch implementations, selected by ``cfg.moe_impl`` as in the
reference:

* ``gather`` (default): capacity-bounded dispatch.  Each (slot, token)
  assignment gets a position inside its expert's capacity buffer from a
  cumulative count (slot-major: every token's first choice before any
  second choice, as GShard); an index map drives a row gather into the
  expert buffers and a row gather back for the combine.
* ``einsum``: the GShard one-hot dispatch / combine einsums, the
  reference's oracle.

Routing groups: a group is one sequence (prefill and training route S
tokens with C = ceil(S k / E * capacity_factor) and may drop tokens;
decode routes one token a group with C = k and never drops).  Dropped
assignments lose their routed contribution; the shared experts always
run.  The router aux loss is the switch-transformer load-balance loss
``E * sum_e f_e * P_e`` per group, averaged over the groups.

Two differences of layout, none of arithmetic:

* the expert buffers are (E, G * C, d), one row block an expert, so the
  expert products are three batched matrix products
  (:func:`_experts_apply`); the reference holds them as (G, E, C, d);
* both row gathers are one autograd Function (:class:`_RowGather`) whose
  backward is a gather through the inverse map: a token's gradient sums
  its k slots in slot order.  Autograd of an index gather would
  ``index_add_`` instead, whose CUDA atomics add in a varying order, so
  two identical training runs would differ.  Under remat the layer's
  forward runs again in the backward; the router's products are
  deterministic, so the recompute routes every token as the forward did.

On a model axis (``split``, a :class:`repro_torch.core.collective.
ModelSplit`; training, gather dispatch) the experts run expert-parallel:
the router stays replicated (every process routes every token alike and
computes the aux loss once from the replicated gates), each process
fills and runs only its E / k experts' buffer rows and combines their
outputs; the combine weights enter through *f* (the router's gradient
reaches them only through this process's experts), and the shared
experts split d_ff as the MLP does.  The partial outputs are summed over
the axis once (*g*).

The router, the expert products, the gather dispatch and its backward
gathers are ``repro_torch.tracing`` spans (``moe.router``,
``moe.experts``, ``moe.dispatch``, ``moe.gather_bwd``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from repro_torch import tracing
from repro_torch.models.blocks import dense_init

__all__ = ["init_moe", "moe_ffn", "moe_capacity", "experts_split",
           "shared_split"]


def init_moe(generator, d_model: int, n_experts: int, n_shared: int,
             moe_d_ff: int, dtype, *, device) -> dict:
    def w(shape):
        return dense_init(generator, shape, dtype, device=device)

    p = {
        "router": w((d_model, n_experts)),
        "w_gate": w((n_experts, d_model, moe_d_ff)),
        "w_up": w((n_experts, d_model, moe_d_ff)),
        "w_down": w((n_experts, moe_d_ff, d_model)),
    }
    if n_shared > 0:
        ff = n_shared * moe_d_ff
        p["shared_gate"] = w((d_model, ff))
        p["shared_up"] = w((d_model, ff))
        p["shared_down"] = w((ff, d_model))
    return p


def moe_capacity(tokens_per_group: int, n_experts: int, k: int,
                 capacity_factor: float) -> int:
    c = int(math.ceil(tokens_per_group * k / n_experts * capacity_factor))
    return max(c, k)


@tracing.traced("moe.router")
def _route(x, router, k: int):
    """x: (G, S, d) -> (gates (G, S, E) float32, topv (G, S, k), topi
    (G, S, k)).  ``jax.lax.top_k`` picks the lower index among equal
    gates; ``torch.topk`` promises no order on ties, so the choice is a
    stable descending sort, and the values are gathered by the chosen
    indices (their gradient flows to those gates, as top_k's does)."""
    logits = (x @ router).to(torch.float32)
    gates = torch.softmax(logits, dim=-1)
    topi = torch.sort(gates, dim=-1, descending=True,
                      stable=True).indices[..., :k]
    topv = torch.gather(gates, -1, topi)
    topv = topv / torch.clamp(torch.sum(topv, dim=-1, keepdim=True),
                              min=1e-9)
    return gates, topv, topi


def _aux_loss(gates, topi, n_experts: int) -> torch.Tensor:
    """Switch load-balance loss per group, averaged over the groups."""
    # fraction of (token, slot) assignments per expert
    assign = F.one_hot(topi, n_experts).to(torch.float32)   # (G, S, k, E)
    f = torch.mean(torch.sum(assign, dim=2), dim=1)          # (G, E)
    P = torch.mean(gates, dim=1)                             # (G, E)
    return torch.mean(torch.sum(f * P, dim=-1)) * n_experts


@tracing.traced("moe.experts")
def _experts_apply(params, expert_in):
    """expert_in: (E, N, d), expert e's N buffer rows -> (E, N, d) through
    the gated-MLP experts (float32 batched products)."""
    h_gate = F.silu(torch.bmm(expert_in, params["w_gate"]))
    h_up = torch.bmm(expert_in, params["w_up"])
    return torch.bmm(h_gate * h_up, params["w_down"])


def _positions(topi, n_experts: int, capacity: int):
    """The slot-major dispatch of the reference: ``(flat_e, pos, keep)``,
    each (G, k * S) in slot-major order (entry j * S + s is token s's
    j-th choice): its expert, the count of earlier assignments to that
    expert (its position in the expert's buffer) and ``pos < C``."""
    G, S, k = topi.shape
    flat_e = topi.transpose(1, 2).reshape(G, S * k)
    # the one-hot as (G, E, kS): the count runs along the last axis (a
    # scan along a middle axis runs each of its G * E columns serially)
    oh = F.one_hot(flat_e, n_experts).transpose(1, 2).contiguous()
    pos_all = torch.cumsum(oh, dim=-1) - oh                   # count before
    pos = torch.gather(pos_all, 1, flat_e[:, None, :])[:, 0]
    return flat_e, pos, pos < capacity


def _maps(flat_e, pos, keep, S: int, n_experts: int, capacity: int):
    """Row maps over the global layouts: tokens ``g * S + s`` of the
    (G * S, d) input, assignments ``j * G * S + g * S + s`` of the
    (k * G * S, d) combine rows, buffer rows ``e * G * C + g * C + c`` of
    the (E * G * C, d) expert buffers.  Returns

      slot  (k, G * S)  the buffer row of each assignment (E * G * C for
                        a dropped one: the zero pad row);
      src   (E * G * C,) the assignment that fills each buffer row (the
                        pad k * G * S where the row is empty);
      tok   (E * G * C,) the token of each buffer row (the pad G * S).

    ``slot`` and ``src`` are inverse maps on the kept assignments."""
    G, kS = flat_e.shape
    k = kS // S
    E, C = n_experts, capacity
    dev = flat_e.device
    g = torch.arange(G, device=dev)[:, None]
    rows = E * G * C
    slot = torch.where(keep, flat_e * (G * C) + g * C + pos, rows)
    slot = slot.reshape(G, k, S).transpose(0, 1).reshape(k, G * S)
    assign = torch.arange(k * G * S, device=dev)
    src = torch.full((rows + 1,), k * G * S, dtype=torch.int64, device=dev)
    # dropped assignments all write the pad row `rows`, the only index
    # with duplicates; the row is discarded below
    src.scatter_(0, slot.reshape(-1), assign)
    src = src[:rows]
    tok = torch.where(src < k * G * S, src % (G * S), G * S)
    return slot, src, tok


class _RowGather(torch.autograd.Function):
    """``out = cat(src, zero row)[index]``; the backward is a gather too:
    ``grad_src[t] = sum_j cat(grad, zero row)[inverse[j, t]]``, the j
    summed in index order, no atomics.  ``inverse`` (m, len(src)) must
    list, for each source row, every output row that copies it (padded
    with ``len(index)``)."""

    @staticmethod
    def forward(ctx, src, index, inverse):
        ctx.save_for_backward(inverse)
        return torch.cat([src, src.new_zeros((1,) + src.shape[1:])])[index]

    @staticmethod
    @once_differentiable
    @tracing.traced("moe.gather_bwd")
    def backward(ctx, grad):
        (inverse,) = ctx.saved_tensors
        pad = torch.cat([grad, grad.new_zeros((1,) + grad.shape[1:])])
        out = pad[inverse[0]]
        for j in range(1, inverse.shape[0]):
            out = out + pad[inverse[j]]
        return out, None, None


def experts_split(dims: dict, impl: str) -> bool:
    """Whether the routed experts of these cut dims run expert-parallel
    (the expert stacks cut on E; the gather dispatch)."""
    return dims.get("w_gate") is not None and impl == "gather"


def shared_split(dims: dict) -> bool:
    """Whether the shared experts run on their d_ff block."""
    return dims.get("shared_gate") is not None


@tracing.traced("moe.dispatch")
def _moe_gather(params, x, *, n_experts: int, k: int, capacity: int,
                with_aux: bool = True, split=None, h=None):
    """Capacity-bounded gather dispatch.  x: (G, S, d).  With ``split``
    the expert stacks are this process's E / k experts: only their
    buffer rows are filled and run (from ``h``, x through *f*), and the
    output is this process's partial sum."""
    G, S, d = x.shape
    E, C = n_experts, capacity
    gates, topv, topi = _route(x, params["router"], k)
    flat_e, pos, keep = _positions(topi, E, C)
    slot, src, tok = _maps(flat_e, pos, keep, S, E, C)
    if split is not None:
        # this process's buffer rows; assignments elsewhere take the pad
        rows = params["w_gate"].shape[0] * G * C
        lo = split.index * rows
        slot = torch.where((slot >= lo) & (slot < lo + rows), slot - lo,
                           rows)
        tok, src, x = tok[lo:lo + rows], src[lo:lo + rows], h
        topv = split.copy(topv)
    n_exp = tok.shape[0] // (G * C)
    expert_in = _RowGather.apply(x.reshape(G * S, d), tok, slot)
    expert_out = _experts_apply(params, expert_in.view(n_exp, G * C, d))
    # combine: each kept assignment's output row, weighted by its gate
    gathered = _RowGather.apply(expert_out.view(n_exp * G * C, d),
                                slot.reshape(-1), src[None])
    gathered = gathered.view(k, G * S, d)
    w = (topv.transpose(1, 2) * keep.view(G, k, S)).transpose(0, 1) \
        .reshape(k, G * S, 1).to(gathered.dtype)
    y = gathered[0] * w[0]
    for j in range(1, k):
        y = y + gathered[j] * w[j]
    return y.view(G, S, d), (_aux_loss(gates, topi, E) if with_aux
                             else None)


def _moe_einsum(params, x, *, n_experts: int, k: int, capacity: int,
                with_aux: bool = True):
    """GShard one-hot reference implementation.  x: (G, S, d)."""
    G, S, d = x.shape
    E, C = n_experts, capacity
    gates, topv, topi = _route(x, params["router"], k)
    counts = torch.zeros((G, E), dtype=torch.int64, device=x.device)
    combine = torch.zeros((G, S, E, C), dtype=torch.float32, device=x.device)
    slots = torch.arange(C, device=x.device)
    for j in range(k):
        oh = F.one_hot(topi[..., j], E)                           # (G, S, E)
        prior = counts[:, None, :] + torch.cumsum(oh, dim=1) - oh
        pos_tok = torch.sum(prior * oh, dim=-1)                   # (G, S)
        keep = (pos_tok < C) & (torch.sum(oh, dim=-1) > 0)
        # jax.nn.one_hot of an index >= C is all zeros
        slot_oh = (pos_tok[..., None] == slots).to(torch.float32)
        combine = combine + (oh.to(torch.float32)[..., None]
                             * slot_oh[:, :, None, :]
                             * (topv[..., j] * keep)[..., None, None])
        counts = counts + torch.sum(oh, dim=1)
    dispatch = (combine > 0).to(x.dtype)
    expert_in = torch.einsum("gsec,gsd->gecd", dispatch, x)
    expert_out = _experts_apply(
        params, expert_in.transpose(0, 1).reshape(E, G * C, d))
    expert_out = expert_out.view(E, G, C, d).transpose(0, 1)
    y = torch.einsum("gsec,gecd->gsd", combine.to(x.dtype), expert_out)
    return y, _aux_loss(gates, topi, E) if with_aux else None


def _sum(a, b):
    return b if a is None else a if b is None else a + b


def moe_ffn(params: dict, x: torch.Tensor, *, n_experts: int, k: int,
            capacity_factor: float = 1.25, impl: str = "gather",
            n_shared: int = 0, with_aux: bool = True, split=None):
    """MoE FFN over x: (B, S, d) (B = routing groups).  Returns (y, aux);
    aux is None unless ``with_aux`` (decode discards it).  ``split``:
    this process's experts of a model axis (a part that does not split
    makes its cut leaves whole and runs on every process)."""
    B, S, d = x.shape
    C = moe_capacity(S, n_experts, k, capacity_factor)
    routed = split is not None and experts_split(split.dims, impl)
    shared = split is not None and n_shared > 0 and shared_split(split.dims)
    h = x
    if split is not None:
        names = [n for n in ("w_gate", "w_up", "w_down") if not routed] \
            + [n for n in ("shared_gate", "shared_up", "shared_down")
               if n_shared > 0 and not shared]
        params = {**params, **split.whole({n: params[n] for n in names})}
        if routed or shared:
            h = split.copy(x)
    fn = _moe_gather if impl == "gather" else _moe_einsum
    y, aux = fn(params, x, n_experts=n_experts, k=k, capacity=C,
                with_aux=with_aux,
                **(dict(split=split, h=h) if routed else {}))
    partial, whole = (y, None) if routed else (None, y)
    if n_shared > 0:
        hs = h if shared else x
        gate = F.silu(hs @ params["shared_gate"])
        ys = (gate * (hs @ params["shared_up"])) @ params["shared_down"]
        if shared:
            partial = _sum(partial, ys)
        else:
            whole = _sum(whole, ys)
    if partial is not None:
        partial = split.reduce(partial)
    return _sum(whole, partial), aux
