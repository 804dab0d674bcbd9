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
    picks); :meth:`MeshAxis.ordered_max` the same for ``pmax``.

:data:`GATHERED` counts the gathers and the bytes of their outputs (what
crossed the wire plus each process's own part) since the last
:func:`reset_gathered`; :data:`REDUCED` counts the model axis's sums and
maxima the same way (their gathers and those gathers' output bytes)
since the last :func:`reset_reduced`.

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

The Megatron split (the 2-D engine's model axis dividing the FLOPs) runs
each product on this process's block of its weights and joins the
blocks' results with two region functions, autograd Functions on an
axis: :func:`copy_to` (Megatron's *f*: the identity forward, the
rank-ordered sum of the gradient backward) where a tensor that every
process holds enters a product on blocks, and :func:`reduce_from`
(*g*: the rank-ordered sum forward, the identity backward) where the
blocks' partial sums leave it.  :class:`ModelSplit` is one module's view
of its parameters on the axis.  With one process on the axis each region
function returns its input.
"""
from __future__ import annotations

import collections
import math
import weakref

import torch
import torch.distributed as dist

from repro_torch import tracing

__all__ = ["MeshAxis", "GATHERED", "REDUCED", "reset_gathered",
           "reset_reduced", "whole_of", "gather_blocks", "block_of",
           "copy_to", "reduce_from", "ModelSplit"]

def reset_gathered() -> None:
    """Zero the counts; the peak restarts from what is alive now."""
    live = GATHERED["live"]
    GATHERED.clear()
    GATHERED["live"] = GATHERED["peak"] = live


def reset_reduced() -> None:
    REDUCED.clear()


#: "calls" / "bytes": the all_gathers run and their output bytes;
#: "live" / "peak": the bytes of :func:`whole_of`'s tensors alive now and
#: at most (the ``gathered`` group of ``repro_torch.tracing``'s counters)
GATHERED: collections.Counter = tracing.counter("gathered",
                                                reset=reset_gathered)
#: "calls" / "bytes": the model axis's rank-ordered sums and maxima (the
#: region functions' and the gathered leaves' gradient sums): their
#: all_gathers and those gathers' output bytes (the ``reduced`` group)
REDUCED: collections.Counter = tracing.counter("reduced")


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

    def all_gather(self, x: torch.Tensor, counter=GATHERED) -> torch.Tensor:
        """(size_k, ..., size_1, *x.shape) for dims 1..k named in order:
        each dim's gather puts its axis in front.  ``counter`` counts
        the gathers (:data:`GATHERED` or :data:`REDUCED`)."""
        out = x
        for name in self.names:
            out = self._gather_dim(out, name, counter)
        return out

    def _gather_dim(self, x: torch.Tensor, name: str,
                    counter) -> torch.Tensor:
        size = self.dim_size(name)
        x = x.contiguous()
        out = torch.empty((size,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        if x.numel():
            wire = (lambda t: t.view(torch.uint8)) \
                if x.dtype == torch.bool else (lambda t: t)
            _gather_into(wire(out).reshape(-1), wire(x).reshape(-1),
                         self.mesh.get_group(self._dim(name)))
        counter["calls"] += 1
        counter["bytes"] += out.numel() * out.element_size()
        return out

    def ordered_sum(self, x: torch.Tensor, counter=GATHERED) -> torch.Tensor:
        """Sum of ``x`` over the axis, the parts added in rank order from
        rank 0's: bit-identical on every process."""
        parts = self.all_gather(x, counter).reshape((-1,) + tuple(x.shape))
        acc = parts[0].clone()
        for i in range(1, parts.shape[0]):
            acc += parts[i]
        return acc

    def ordered_max(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise max of ``x`` over the axis (the same bits on every
        process), counted in :data:`REDUCED`."""
        parts = self.all_gather(x, REDUCED).reshape((-1,) + tuple(x.shape))
        return parts.amax(dim=0)


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
    whole gradient (its own buffer, so the whole one is freed at once),
    or with ``summed`` its block of the rank-ordered sum of every
    process's whole gradient (each process used a part of the whole
    tensor, so each holds a partial gradient)."""

    @staticmethod
    def forward(ctx, block, axis, dim, summed):
        ctx.axis, ctx.dim, ctx.summed = axis, dim, summed
        return whole_of(block, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        axis, dim = ctx.axis, ctx.dim
        if not ctx.summed:
            return block_of(grad, axis, dim), None, None, None
        size = grad.shape[dim] // axis.size
        parts = axis.all_gather(grad.contiguous(), REDUCED)
        acc = parts[0].narrow(dim, axis.index * size, size).clone(
            memory_format=torch.contiguous_format)
        for i in range(1, parts.shape[0]):
            acc += parts[i].narrow(dim, axis.index * size, size)
        return acc, None, None, None


def gather_blocks(block: torch.Tensor, axis: MeshAxis, dim) -> torch.Tensor:
    """:func:`whole_of` under autograd: the gradient reaching the whole
    tensor comes back as this process's block of it.  Every process on
    the axis must compute the same whole gradient (the 2-D engine's model
    shards do: each sees its client row's whole batch)."""
    if not _cut(axis, dim):
        return block
    return _GatherBlocks.apply(block, axis, dim, False)


class _CopyTo(torch.autograd.Function):
    """Megatron's *f*: the identity forward; the backward sums the
    gradient over the axis in rank order."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.ordered_sum(grad.contiguous(), REDUCED), None


class _ReduceFrom(torch.autograd.Function):
    """Megatron's *g*: the rank-ordered sum over the axis forward; the
    identity backward."""

    @staticmethod
    def forward(ctx, x, axis):
        return axis.ordered_sum(x.contiguous(), REDUCED)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """*f*: ``x`` (the same on every process) as it enters products on
    this process's blocks; its gradient, a partial sum on each process,
    comes back summed over the axis."""
    return x if axis.size == 1 else _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """*g*: the sum over the axis, in rank order, of each process's
    partial ``x``; the gradient passes through."""
    return x if axis.size == 1 else _ReduceFrom.apply(x, axis)


class ModelSplit:
    """One module's parameters on a ``model`` axis of more than one
    process: ``dims`` maps each leaf's name (a nested dict, as the
    parameters) to the dim its spec cuts on the axis, None where the
    leaf is whole on every process.  The module runs a product on its
    blocks where the cut falls on whole heads, experts or channels, and
    makes the other cut leaves whole (:meth:`whole`)."""

    def __init__(self, axis: MeshAxis, dims: dict):
        self.axis, self.dims = axis, dims

    @property
    def size(self) -> int:
        return self.axis.size

    @property
    def index(self) -> int:
        return self.axis.index

    def sub(self, name: str) -> "ModelSplit":
        """The split of the sub-tree ``name``."""
        return ModelSplit(self.axis, self.dims[name])

    def dim(self, name: str):
        """The cut dim of leaf ``name`` (None: whole, or no such leaf)."""
        return self.dims.get(name)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to(x, self.axis)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_from(x, self.axis)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the axis (no gradient)."""
        return self.axis.ordered_max(x.detach().contiguous())

    def whole(self, tree: dict) -> dict:
        """Every cut leaf of ``tree`` whole (:func:`gather_blocks`: every
        process computes the same whole gradient, each keeps its
        block)."""
        return {k: self.sub(k).whole(v) if isinstance(v, dict)
                else gather_blocks(v, self.axis, self.dims.get(k))
                for k, v in tree.items()}

    def whole_partial(self, leaf: torch.Tensor, name: str) -> torch.Tensor:
        """Leaf ``name`` whole for a product on part of it: each process's
        gradient of it is partial, so the gradients are summed over the
        axis in rank order (a cut leaf gathered, its block of the sum
        kept; a whole leaf through :func:`copy_to`)."""
        dim = self.dims.get(name)
        if dim is None:
            return self.copy(leaf)
        return _GatherBlocks.apply(leaf, self.axis, dim, True)
