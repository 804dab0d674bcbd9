"""Non-IID client partitioning — the paper's §VII-B heterogeneity setup;
the counterpart of ``repro.data.partition`` (numpy, copied: the same
seed gives the same index arrays).

The proportion of samples of each class stored at each client is drawn
from a Dirichlet(alpha) distribution (alpha = 0.5 in the paper), matching
the FedML benchmark's partitioner the paper builds on.
"""
from __future__ import annotations

import numpy as np

__all__ = ["dirichlet_partition", "shard_partition"]


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float = 0.5,
                        seed: int = 0, min_per_client: int = 1):
    """Return a list of index arrays, one per client.

    For each class c, draws p ~ Dir(alpha * 1_n) and splits class-c indices
    across clients proportionally.  Re-draws until every client has at least
    ``min_per_client`` samples.
    """
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    for _attempt in range(100):
        idx_per_client = [[] for _ in range(n_clients)]
        for c in classes:
            idx_c = np.flatnonzero(labels == c)
            rng.shuffle(idx_c)
            p = rng.dirichlet(np.full(n_clients, alpha))
            splits = (np.cumsum(p) * len(idx_c)).astype(int)[:-1]
            for i, part in enumerate(np.split(idx_c, splits)):
                idx_per_client[i].append(part)
        out = [np.concatenate(parts) for parts in idx_per_client]
        if min(len(o) for o in out) >= min_per_client:
            for o in out:
                rng.shuffle(o)
            return out
    raise RuntimeError("could not satisfy min_per_client after 100 draws")


def shard_partition(n_samples: int, n_clients: int, seed: int = 0):
    """IID contiguous shards (the paper's §VII-A logistic-regression split:
    'shuffled examples ... we did not perform any extra shuffling')."""
    per = n_samples // n_clients
    return [np.arange(i * per, (i + 1) * per) for i in range(n_clients)]
