"""Named mesh axes on ``torch.distributed`` — the port's stand-in for the
axis names the reference's ``shard_map`` bodies use.

The reference runs a sharded function once per device inside
``shard_map`` and names the collective's axis by a string.  The port is
SPMD in eager PyTorch: every process runs the same Python on its own
shard, and a :class:`MeshAxis` carries what the string resolved to there
— the ``DeviceMesh``, the dim (or dims) of it, this process's index along
them, and their process groups.

Collectives on an axis:

  * :meth:`MeshAxis.all_gather` — ``jax.lax.all_gather(x, name)``: a new
    leading axis of the axis size, in the axis's rank order.  Over
    several dims (``("pod", "data")``) it gathers one dim after another
    in the order named, as the reference's loop of gathers does, so the
    leading axes come out last-named first.
  * :meth:`MeshAxis.ordered_sum` — ``psum`` of a small tensor: gathered,
    then added in rank order on every process, so each process holds the
    same bits (an ``all_reduce`` sums in whatever order the backend
    picks).

:data:`GATHERED` counts the gathers and the bytes of their outputs (what
crossed the wire plus each process's own part) since the last
:func:`reset_gathered`.

A tensor cut on one dim over an axis (each process holds its block, as
the 2-D engine holds a leaf cut on ``model``) is made whole by
:func:`whole_of`: the blocks gathered and joined on that dim in rank
order.  :func:`gather_blocks` does the same as an autograd Function whose
backward keeps this process's block of the whole gradient (every process
computes the same whole gradient, so no reduce is needed), and
:func:`block_of` cuts a whole tensor back to this process's block.  With
one process on the axis, or no dim cut, all three return their input.
``GATHERED["live"]`` holds the bytes of the whole tensors that
:func:`whole_of` made and that are still alive, ``GATHERED["peak"]`` the
most of them alive at once since the last :func:`reset_gathered`.
"""
from __future__ import annotations

import collections
import math
import weakref

import torch
import torch.distributed as dist

__all__ = ["MeshAxis", "GATHERED", "reset_gathered", "whole_of",
           "gather_blocks", "block_of"]

#: "calls" / "bytes": the all_gathers run and their output bytes;
#: "live" / "peak": the bytes of :func:`whole_of`'s tensors alive now and
#: at most
GATHERED: collections.Counter = collections.Counter()


def reset_gathered() -> None:
    """Zero the counts; the peak restarts from what is alive now."""
    live = GATHERED["live"]
    GATHERED.clear()
    GATHERED["live"] = GATHERED["peak"] = live


def _release(nbytes: int) -> None:
    GATHERED["live"] -= nbytes


def _gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    # all_gather_single is the name from torch 2.13 on; older releases
    # have only all_gather_into_tensor
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, x, group=group)


class MeshAxis:
    """One or more named dims of a ``DeviceMesh``, seen from this
    process."""

    def __init__(self, mesh, names):
        self.mesh = mesh
        self.names = (names,) if isinstance(names, str) else tuple(names)
        for name in self.names:
            if name not in (mesh.mesh_dim_names or ()):
                raise ValueError(f"mesh has no axis {name!r}; its axes are "
                                 f"{mesh.mesh_dim_names}")

    def __repr__(self) -> str:
        return f"MeshAxis({self.names}, size={self.size})"

    def _dim(self, name: str) -> int:
        return self.mesh.mesh_dim_names.index(name)

    def dim_size(self, name: str) -> int:
        return int(self.mesh.shape[self._dim(name)])

    def dim_index(self, name: str) -> int:
        """``jax.lax.axis_index(name)``: this process's coordinate."""
        return int(self.mesh.get_local_rank(self._dim(name)))

    @property
    def size(self) -> int:
        return math.prod(self.dim_size(n) for n in self.names)

    @property
    def index(self) -> int:
        """The row-major index over the dims (``axis_index`` of a tuple
        of names)."""
        idx = 0
        for name in self.names:
            idx = idx * self.dim_size(name) + self.dim_index(name)
        return idx

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(size_k, ..., size_1, *x.shape) for dims 1..k named in order:
        each dim's gather puts its axis in front."""
        out = x
        for name in self.names:
            out = self._gather_dim(out, name)
        return out

    def _gather_dim(self, x: torch.Tensor, name: str) -> torch.Tensor:
        size = self.dim_size(name)
        x = x.contiguous()
        out = torch.empty((size,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        if x.numel():
            wire = (lambda t: t.view(torch.uint8)) \
                if x.dtype == torch.bool else (lambda t: t)
            _gather_into(wire(out).reshape(-1), wire(x).reshape(-1),
                         self.mesh.get_group(self._dim(name)))
        GATHERED["calls"] += 1
        GATHERED["bytes"] += out.numel() * out.element_size()
        return out

    def ordered_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of ``x`` over the axis, the parts added in rank order from
        rank 0's: bit-identical on every process."""
        parts = self.all_gather(x).reshape((-1,) + tuple(x.shape))
        acc = parts[0].clone()
        for i in range(1, parts.shape[0]):
            acc += parts[i]
        return acc


def _cut(axis, dim) -> bool:
    return dim is not None and axis.size > 1


def whole_of(block: torch.Tensor, axis: MeshAxis, dim) -> torch.Tensor:
    """The whole tensor of which every process on ``axis`` holds a block
    cut on ``dim``: the blocks gathered and joined on ``dim`` in rank
    order (``block`` itself when nothing is cut)."""
    if not _cut(axis, dim):
        return block
    out = torch.cat(list(axis.all_gather(block).unbind(0)), dim=dim)
    nbytes = out.numel() * out.element_size()
    GATHERED["live"] += nbytes
    GATHERED["peak"] = max(GATHERED["peak"], GATHERED["live"])
    weakref.finalize(out, _release, nbytes)
    return out


def block_of(x: torch.Tensor, axis: MeshAxis, dim) -> torch.Tensor:
    """This process's block of a whole tensor cut on ``dim`` over
    ``axis``, in a buffer of its own (``x`` itself when nothing is
    cut)."""
    if not _cut(axis, dim):
        return x
    size = x.shape[dim] // axis.size
    return x.narrow(dim, axis.index * size, size).clone(
        memory_format=torch.contiguous_format)


class _GatherBlocks(torch.autograd.Function):
    """:func:`whole_of` forward; backward: this process's block of the
    whole gradient (its own buffer, so the whole one is freed at once)."""

    @staticmethod
    def forward(ctx, block, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return whole_of(block, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return block_of(grad, ctx.axis, ctx.dim), None, None


def gather_blocks(block: torch.Tensor, axis: MeshAxis, dim) -> torch.Tensor:
    """:func:`whole_of` under autograd: the gradient reaching the whole
    tensor comes back as this process's block of it.  Every process on
    the axis must compute the same whole gradient (the 2-D engine's model
    shards do: each sees its client row's whole batch)."""
    if not _cut(axis, dim):
        return block
    return _GatherBlocks.apply(block, axis, dim)
