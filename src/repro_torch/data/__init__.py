"""Synthetic datasets of the paper's convex experiments."""
from repro_torch.data.logreg import LogRegData, logreg_loss_and_grad, make_logreg_data

__all__ = ["LogRegData", "make_logreg_data", "logreg_loss_and_grad"]
