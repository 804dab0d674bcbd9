"""Beyond-paper algorithmic extensions — the paper's §VIII future work;
the counterpart of ``repro.core.extensions``.

1. **Error-feedback aggregation for BIASED compressors.**  Classic EF
   [Stich et al. 2018, Karimireddy et al. 2019]: each client keeps a
   residual e_i, transmits C(x_i + e_i) and updates
   e_i <- x_i + e_i - C(x_i + e_i), so the bias is re-injected instead of
   lost.  :func:`ef_average` realizes the uplink; the master path stays
   shared-key.

2. **Compressed local updates.**  :func:`compress_grads` applies an
   unbiased compressor to the per-client gradients before the local
   step — the estimator stays unbiased.

Key schedule, the reference's: ``k_clients, k_master = split(key)`` and
client i compresses with ``split(k_clients, n)[i]``.  The reference maps
``tree_apply`` over the clients with ``vmap``; here the n client keys go
to the codec in one call (a key batch (n, 2) with a leading client axis
on the tree), which draws client i's bits from its own key.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.core import prng
from repro_torch.core.compressors import Compressor, tree_apply
from repro_torch.core.tree import tree_leaves, tree_map

__all__ = ["EFMemory", "init_ef_memory", "ef_average", "compress_grads"]


class EFMemory(NamedTuple):
    residual: Any   # tree matching the stacked client params (leading axis n)


def init_ef_memory(params_stacked) -> EFMemory:
    return EFMemory(tree_map(torch.zeros_like, params_stacked))


def ef_average(key, params_stacked, memory: EFMemory,
               client_comp: Compressor, master_comp: Compressor
               ) -> Tuple[Any, EFMemory]:
    """Error-feedback compressed average.

    Returns (target, new_memory): target = C_M( (1/n) sum_i C(x_i + e_i) ),
    new e_i = (x_i + e_i) - C(x_i + e_i).  With an unbiased compressor the
    residual stays ~0 and this reduces to the paper's Algorithm 1 uplink.
    The mean is the reference's ``jnp.mean`` (:func:`client_mean`)."""
    from repro_torch.core.aggregation import client_mean
    n = tree_leaves(params_stacked)[0].shape[0]
    k_clients, k_master = prng.split(key)
    client_keys = prng.split(k_clients, n)
    corrected = tree_map(lambda x, e: x + e.to(x.dtype), params_stacked,
                         memory.residual)
    compressed = tree_apply(client_comp, client_keys, corrected)
    new_residual = tree_map(lambda c, q: (c - q).to(c.dtype), corrected,
                            compressed)
    ybar = tree_map(client_mean, compressed)
    target = tree_apply(master_comp, k_master, ybar)
    return target, EFMemory(new_residual)


def compress_grads(key, grads_stacked, comp: Compressor):
    """Compress per-client gradients (leading client axis) with
    independent keys ``split(key, n)`` — compute- or energy-limited
    devices quantizing their own backward pass.  An unbiased ``comp``
    keeps the L2GD estimator unbiased."""
    n = tree_leaves(grads_stacked)[0].shape[0]
    return tree_apply(comp, prng.split(key, n), grads_stacked)
