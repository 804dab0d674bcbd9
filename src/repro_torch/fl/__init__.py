"""FL runtime of the port: the L2GD protocol driver and the bits/n ledger."""
from repro_torch.fl.ledger import BitsLedger, per_client_uplink
from repro_torch.fl.l2gd_driver import L2GDRun, run_l2gd

__all__ = ["BitsLedger", "per_client_uplink", "L2GDRun", "run_l2gd"]
