"""Data substrate: the Dirichlet non-IID partitioner, the paper's convex
experiments and the LM token stream."""
from repro_torch.data.partition import dirichlet_partition, shard_partition
from repro_torch.data.logreg import LogRegData, logreg_loss_and_grad, make_logreg_data
from repro_torch.data.tokens import TokenStream, make_client_batch

__all__ = ["dirichlet_partition", "shard_partition", "LogRegData",
           "make_logreg_data", "logreg_loss_and_grad", "TokenStream",
           "make_client_batch"]
