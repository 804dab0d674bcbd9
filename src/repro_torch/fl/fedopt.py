"""FedOpt baseline [Reddi et al. 2020] — FedAvg with a server-side Adam;
the counterpart of ``repro.fl.fedopt``.

Thin wrapper over run_fedavg(server='adam'); kept as its own module so the
benchmarks read like the paper ('the only comparable baseline for L2GD is
FedOpt')."""
from __future__ import annotations

from repro_torch.fl.fedavg import run_fedavg

__all__ = ["run_fedopt"]


def run_fedopt(key, global_params, grad_fn, client_batches_fn, n_clients,
               rounds, local_lr, server_lr=1e-2, **kw):
    return run_fedavg(key, global_params, grad_fn, client_batches_fn,
                      n_clients, rounds, local_lr, compressor=None,
                      server="adam", server_lr=server_lr, **kw)
