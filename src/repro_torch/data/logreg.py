"""Synthetic a1a-like binary classification data for the paper's convex
experiments (§VII-A): d = 124 features, labels in {+1, -1}, 5 clients —
the counterpart of ``repro.data.logreg``.

``make_logreg_data`` is the reference's numpy generator, copied verbatim:
the same seed gives the same bytes.  ``logreg_loss_and_grad`` is the
paper's f_i in PyTorch, batched over any leading (client) axes.

Heterogeneity: each client's positives are generated from a client-shifted
separating hyperplane, so the per-client optimal models genuinely differ —
the regime where personalization (lambda finite) beats the global model.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["LogRegData", "make_logreg_data", "logreg_loss_and_grad"]


class LogRegData(NamedTuple):
    features: np.ndarray   # (n_clients, m, d)
    labels: np.ndarray     # (n_clients, m) in {+1,-1}


def make_logreg_data(n_clients: int = 5, m_per_client: int = 321,
                     d: int = 124, heterogeneity: float = 1.0,
                     seed: int = 0) -> LogRegData:
    rng = np.random.default_rng(seed)
    w_shared = rng.normal(size=d) / np.sqrt(d)
    feats, labs = [], []
    for i in range(n_clients):
        w_i = w_shared + heterogeneity * rng.normal(size=d) / np.sqrt(d)
        X = rng.normal(size=(m_per_client, d))   # unit features -> margins O(1)
        margin = X @ w_i + 0.1 * rng.normal(size=m_per_client)
        y = np.where(margin >= 0, 1.0, -1.0)
        feats.append(X)
        labs.append(y)
    return LogRegData(np.stack(feats).astype(np.float32),
                      np.stack(labs).astype(np.float32))


def logreg_loss_and_grad(w: torch.Tensor, X: torch.Tensor, y: torch.Tensor,
                         l2: float = 0.01):
    """l2-regularized logistic loss and its gradient — the paper's f_i.
    w: (..., d), X: (..., m, d), y: (..., m); returns (loss (...),
    grad (..., d)), so stacked clients are one call."""
    z = -y * torch.matmul(X, w.unsqueeze(-1)).squeeze(-1)
    loss = torch.logaddexp(torch.zeros_like(z), z).mean(dim=-1) \
        + 0.5 * l2 * torch.sum(w * w, dim=-1)
    sig = torch.where(z > 0, 1.0 / (1.0 + torch.exp(-z)),
                      torch.exp(z) / (1.0 + torch.exp(z)))
    grad = -(X * (y * sig).unsqueeze(-1)).mean(dim=-2) + l2 * w
    return loss, grad
