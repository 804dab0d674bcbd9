"""Read-heavy serving — the counterpart of ``repro.serve``: one resident
base, per-tenant compressed deltas decoded on demand through the unpack
kernels, continuous mixed-tenant batching bit for bit with solo serving."""
from repro_torch.serve.store import DeltaModelStore, plan_spec, plan_from_spec
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.metrics import TenantStats, ServeMetrics

__all__ = ["DeltaModelStore", "plan_spec", "plan_from_spec",
           "Request", "ServingEngine", "TenantStats", "ServeMetrics"]
