"""Sharding rules: param path -> partition spec — the counterpart of
``repro.launch.sharding``.

Megatron-style tensor parallelism over the ``model`` axis plus the FL
client axis for stacked personalized models:

  * attention qkv: shard the fused head output dim; o-proj input dim
  * MLP: shard d_ff (gate/up output, down input)
  * MoE: shard the EXPERT dim (expert parallelism), router replicated
  * Mamba: shard d_inner everywhere (in/out proj, conv, A, D, dt)
  * embedding / lm head: shard the vocab dim
  * norms, small biases: replicated

Every rule checks divisibility by the model axis's size and falls back
to replication when a dim does not divide.  A spec is a tuple with one
entry a dim: an axis name, a tuple of names, or ``None`` (replicated) —
the reference's ``PartitionSpec`` as a plain tuple.  The rules are pure
functions of paths and shapes (trees of tensors, ``meta`` tensors
included).

On a ``DeviceMesh`` a spec becomes placements (:func:`placements`:
``Shard(d)`` / ``Replicate()`` per mesh dim), and :func:`local_slice`
cuts a tensor to this process's part of it: what the reference's
``NamedSharding`` placement does with ``jax.device_put``.  The
``*_shardings`` functions below cut a whole tree that way.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.tree import tree_map

__all__ = ["param_pspecs", "batch_pspec", "cache_pspecs",
           "train_state_pspecs", "placements", "local_slice",
           "tree_local", "client_sharded_shardings",
           "client_sharded_batch_shardings", "train_state_shardings",
           "train_batch_shardings", "map_with_path", "MODEL_AXIS"]

MODEL_AXIS = "model"


def map_with_path(fn, tree, names=()):
    """``jax.tree_util.tree_map_with_path`` over the port's trees:
    ``fn(names, leaf)`` with ``names`` the dict keys, NamedTuple field
    names and list indices (as strings) from the root down."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, names + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, v, names + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, names + (str(i),))
                          for i, v in enumerate(tree))
    return fn(list(names), tree)


def _leaf_spec(names: list, shape, model_size: int, n_prefix: int,
               serve_mode: bool = False) -> list:
    """Spec dims for one param leaf AFTER ``n_prefix`` leading axes
    (client axis and/or layer-stacking axis) which the caller fills."""
    name = names[-1]
    body = tuple(shape)[n_prefix:]
    nd = len(body)
    div = lambda i: body[i] % model_size == 0
    M = MODEL_AXIS

    # --- MoE experts: 3-D (E, d, ff) / router 2-D handled below ------------
    if name in ("w_gate", "w_up", "w_down") and nd == 3:
        return [M if div(0) else None, None, None]
    if name in ("w_gate", "w_up", "shared_gate", "shared_up", "w_in") \
            and nd == 2:
        return [None, M if div(1) else None]
    if name in ("w_down", "shared_down") and nd == 2:
        return [M if div(0) else None, None]
    if name == "router":
        return [None, None]
    # --- attention ---------------------------------------------------------
    if name in ("wq", "wk", "wv", "wqkv", "w_uk", "w_uv") and nd == 2:
        return [None, M if div(1) else None]
    if name == "wo" and nd == 2:
        return [M if div(0) else None, None]
    # split layout (d, H, hd) / (H, hd, d): serve shards head_dim so the
    # KV-cache update stays reshard-free; train shards heads when divisible
    if name in ("wq", "wk", "wv") and nd == 3:
        if serve_mode and div(2):
            return [None, None, M]
        if not serve_mode and div(1):
            return [None, M, None]
        if div(2):
            return [None, None, M]
        return [None, None, None]
    if name == "wo" and nd == 3:
        if serve_mode and div(1):
            return [None, M, None]
        if not serve_mode and div(0):
            return [M, None, None]
        if div(1):
            return [None, M, None]
        return [None, None, None]
    if name == "w_dkv":
        return [None, None]
    # --- embedding ----------------------------------------------------------
    if name == "table":
        return [M if div(0) else None, None]
    # --- mamba ---------------------------------------------------------------
    if name in ("in_proj_x", "in_proj_z", "dt_proj") and nd == 2:
        return [None, M if div(1) else None]
    if name in ("x_proj", "out_proj", "A_log") and nd == 2:
        return [M if div(0) else None, None]
    if name == "conv_w":
        return [None, M if div(1) else None]
    if name in ("conv_b", "dt_bias", "D") and nd == 1:
        return [M if div(0) else None]
    # --- norms / everything else: replicated --------------------------------
    return [None] * nd


def param_pspecs(params_shapes, model_size: int, client_axes: tuple = (),
                 stacked_layers: bool = True, serve_mode: bool = False):
    """Spec tree for a param tree (tensors or meta tensors).

    ``client_axes``: () for a single (unstacked) model, or e.g.
    ("clients",) / ("pod", "data") when leaves carry a leading client
    axis."""
    n_client = 1 if client_axes else 0

    def one(names, leaf):
        in_layer_group = any(n in ("layers", "dense_layers", "encoder",
                                   "cross") for n in names)
        n_prefix = n_client + (1 if (in_layer_group and stacked_layers)
                               else 0)
        body = _leaf_spec(names, leaf.shape, model_size, n_prefix,
                          serve_mode)
        prefix = []
        if n_client:
            prefix.append(client_axes if len(client_axes) > 1
                          else client_axes[0])
        if in_layer_group and stacked_layers:
            prefix.append(None)
        return tuple(prefix + body)

    return map_with_path(one, params_shapes)


def batch_pspec(client_axes: tuple, extra_dims: int = 2) -> tuple:
    """Spec for per-client batches (n_clients, per_batch, seq[, d])."""
    lead = client_axes if len(client_axes) > 1 else client_axes[0]
    return tuple([lead] + [None] * extra_dims)


def cache_pspecs(caches_shapes, model_size: int, *, batch_axis: Optional[str],
                 seq_axis: Optional[str], axis_sizes: Optional[dict] = None):
    """Specs for decode caches.  KV tensors are (B, C, Kv, hd) (GQA),
    (B, C, R) (MLA latent), (B, K-1, E) / (B, E, N) (Mamba).
    ``batch_axis`` shards B; ``seq_axis`` shards the capacity dim C.  The
    last dim additionally shards over "model" when divisible."""

    def _axis_size(axis) -> int:
        sizes = axis_sizes or {}
        if isinstance(axis, tuple):
            n = 1
            for a in axis:
                n *= sizes.get(a, 16)
            return n
        return sizes.get(axis, 16)

    def one(names, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        dims = [None] * nd
        name = names[-1] if names else ""
        is_kv = name in ("k", "v", "c_kv", "k_rope", "cross_k", "cross_v")
        if batch_axis is not None and shape[0] % _axis_size(batch_axis) == 0:
            dims[0] = batch_axis
        if seq_axis is not None and is_kv and nd >= 2 \
                and shape[1] % _axis_size(seq_axis) == 0:
            dims[1] = seq_axis
        if is_kv and shape[-1] % model_size == 0:
            dims[-1] = MODEL_AXIS            # head_dim / latent rank
        elif name == "conv" and shape[-1] % model_size == 0:
            dims[-1] = MODEL_AXIS            # d_inner
        elif name == "h" and nd >= 2 and shape[1] % model_size == 0:
            dims[1] = MODEL_AXIS             # d_inner (NOT the tiny N dim)
        return tuple(dims)

    return map_with_path(one, caches_shapes)


def train_state_pspecs(state, model_size: int, client_axis: str = "clients"):
    """Spec tree of an :class:`~repro_torch.core.l2gd.L2GDState` on the
    ``(clients, model)`` training mesh: stacked ``params`` shard the
    client axis on ``client_axis`` and their weight dims on "model" by
    the rules above; the ``cache`` (no client axis) is model-sharded
    only; the protocol scalars replicate (``()``).  ``model_size=1``
    makes every model rule replicate."""
    from repro_torch.core.l2gd import L2GDState
    return L2GDState(
        params=param_pspecs(state.params, model_size,
                            client_axes=(client_axis,)),
        cache=param_pspecs(state.cache, model_size, client_axes=()),
        xi_prev=(), step=())


# ---------------------------------------------------------------------------
# specs on a DeviceMesh
# ---------------------------------------------------------------------------

def _entry_names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(mesh, spec) -> tuple:
    """``Shard(d)`` / ``Replicate()`` for each dim of ``mesh`` from a spec
    tuple (a mesh dim the spec does not name replicates)."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh.mesh_dim_names)
    for d, entry in enumerate(spec):
        for name in _entry_names(entry):
            out[mesh.mesh_dim_names.index(name)] = Shard(d)
    return tuple(out)


def local_slice(mesh, spec, x: torch.Tensor) -> torch.Tensor:
    """This process's part of ``x`` under ``spec``: each sharded dim cut
    into the mesh axis's equal blocks (several names on one dim: the
    row-major index over them, as the reference lays a tuple of axes
    out).  A view; raises where a dim does not divide."""
    for d, entry in enumerate(spec):
        names = _entry_names(entry)
        if not names:
            continue
        size, idx = 1, 0
        for name in names:
            dim = mesh.mesh_dim_names.index(name)
            n = int(mesh.shape[dim])
            size, idx = size * n, idx * n + int(mesh.get_local_rank(dim))
        if x.shape[d] % size:
            raise ValueError(f"dim {d} of shape {tuple(x.shape)} does not "
                             f"divide the {names} axis of size {size}")
        block = x.shape[d] // size
        x = x[(slice(None),) * d + (slice(idx * block, (idx + 1) * block),)]
    return x


def tree_local(mesh, spec_tree, tree):
    """:func:`local_slice` of every array leaf of ``tree`` under the
    matching spec of ``spec_tree`` (the same structure, a spec tuple a
    leaf); other leaves (the protocol scalars) pass through."""
    if isinstance(tree, dict):
        return {k: tree_local(mesh, spec_tree[k], v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_local(mesh, s, v)
                            for s, v in zip(spec_tree, tree)))
    if isinstance(tree, list):
        return [tree_local(mesh, s, v) for s, v in zip(spec_tree, tree)]
    if hasattr(tree, "shape") and len(tree.shape):
        return local_slice(mesh, spec_tree, tree)
    return tree


def client_sharded_shardings(mesh, state, axis: str = "clients"):
    """This process's part of an :class:`~repro_torch.core.l2gd.L2GDState`
    on a client mesh: ``params`` cut on the leading client axis, the
    ``cache`` and the protocol scalars whole."""
    from repro_torch.core.rollout import sharded_state_specs
    return tree_local(mesh, sharded_state_specs(state, axis), state)


def train_state_shardings(mesh, state, client_axis: str = "clients"):
    """This process's part of an L2GDState on the ``(clients, model)``
    mesh, by :func:`train_state_pspecs` at the mesh's model size."""
    from repro_torch.launch.mesh import model_shards_of
    return tree_local(mesh, train_state_pspecs(state, model_shards_of(mesh),
                                               client_axis), state)


def _batch_specs(batches, axis, batch_axis):
    if batch_axis is None:
        return tree_map(lambda a: (axis,) + (None,) * (len(a.shape) - 1),
                        batches)
    return tree_map(lambda a: (None, axis) + (None,) * (len(a.shape) - 2),
                    batches)


def train_batch_shardings(mesh, batches, client_axis: str = "clients",
                          batch_axis=0):
    """This process's part of the 2-D engine's batch tree: the client
    axis cut on ``client_axis`` (after the leading steps axis when
    ``batch_axis=0``), the rest whole on every model shard (each model
    shard sees its clients' full batch)."""
    return tree_local(mesh, _batch_specs(batches, client_axis, batch_axis),
                      batches)


def client_sharded_batch_shardings(mesh, batches, axis: str = "clients",
                                   batch_axis=0):
    """This process's part of a rollout's batch tree on a client mesh:
    the client axis (axis 0, or axis 1 after the steps axis when
    ``batch_axis=0``) cut, everything else whole."""
    return tree_local(mesh, _batch_specs(batches, axis, batch_axis), batches)
