"""FL runtime of the port: the L2GD protocol driver, the fault model,
the FedAvg / FedOpt baselines and the bits/n ledger."""
from repro_torch.fl.ledger import BitsLedger, per_client_uplink
from repro_torch.fl.faults import (FaultPlan, fault_draws,
                                   geometric_latency_probs)
from repro_torch.fl.l2gd_driver import L2GDRun, run_l2gd
from repro_torch.fl.fedavg import FedRun, local_sgd_epochs, run_fedavg
from repro_torch.fl.fedopt import run_fedopt

__all__ = ["BitsLedger", "per_client_uplink", "FaultPlan", "fault_draws",
           "geometric_latency_probs", "L2GDRun", "run_l2gd", "FedRun",
           "local_sgd_epochs", "run_fedavg", "run_fedopt"]
