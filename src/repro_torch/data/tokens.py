"""Synthetic token pipeline with per-client distribution skew — a copy of
``repro.data.tokens`` (numpy only).

Each client i has its own affine recurrence ``t_{j+1} = (a_i t_j + b_i + eps)
mod V``: the sequences are learnable (low conditional entropy) but the
transition law differs per client, giving exactly the data heterogeneity
regime personalized FL targets.  Deterministic given (seed, client, step),
so the pipeline is resumable from a checkpointed step counter alone.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

__all__ = ["TokenStream", "make_client_batch"]


class TokenStream:
    """Infinite deterministic per-client batch stream."""

    def __init__(self, n_clients: int, vocab: int, batch: int, seq: int,
                 seed: int = 0, noise: float = 0.05):
        self.n_clients, self.vocab = n_clients, vocab
        self.batch, self.seq = batch, seq
        self.seed, self.noise = seed, noise
        rng = np.random.default_rng(seed)
        # client-specific affine laws; a_i odd so the map is a bijection
        self.a = (rng.integers(1, max(vocab // 2, 2), n_clients) * 2 + 1) % vocab
        self.b = rng.integers(0, vocab, n_clients)

    def batch_at(self, step: int) -> np.ndarray:
        """(n_clients, batch, seq) int32 token batch for a given step."""
        out = np.empty((self.n_clients, self.batch, self.seq), np.int32)
        for i in range(self.n_clients):
            rng = np.random.default_rng((self.seed, i, step))
            t = rng.integers(0, self.vocab, self.batch)
            seqs = np.empty((self.batch, self.seq), np.int64)
            for j in range(self.seq):
                seqs[:, j] = t
                eps = rng.integers(0, self.vocab, self.batch) \
                    * (rng.random(self.batch) < self.noise)
                t = (self.a[i] * t + self.b[i] + eps) % self.vocab
            out[i] = seqs
        return out

    def __iter__(self) -> Iterator[np.ndarray]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_client_batch(key_seed: int, n_clients: int, batch: int, seq: int,
                      vocab: int) -> np.ndarray:
    """One-shot convenience wrapper."""
    return TokenStream(n_clients, vocab, batch, seq, seed=key_seed).batch_at(0)
