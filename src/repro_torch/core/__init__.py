"""Core library of the port: the codec layer, compressors, the L2GD step,
the aggregation layer and the rollout (QSGD slice)."""
from repro_torch.core.codec import (
    CompressionPlan, DensePayload, QSGDPayload, TreePayload, as_plan,
    make_plan,
)
from repro_torch.core.compressors import (
    QSGD, Compressor, Identity, make_compressor,
)
from repro_torch.core.l2gd import (
    L2GDHyper, L2GDState, aggregation_update, draw_xi, init_state, l2gd_step,
    local_update,
)
from repro_torch.core.aggregation import (
    compressed_average, masked_client_mean, stacked_finite_mask,
    weighted_client_sum,
)
from repro_torch.core.rollout import RolloutTrace, rollout_l2gd

__all__ = [
    "CompressionPlan", "DensePayload", "QSGDPayload", "TreePayload",
    "as_plan", "make_plan", "QSGD", "Compressor", "Identity",
    "make_compressor", "L2GDHyper", "L2GDState", "aggregation_update",
    "draw_xi", "init_state", "l2gd_step", "local_update",
    "compressed_average", "masked_client_mean", "stacked_finite_mask",
    "weighted_client_sum", "RolloutTrace", "rollout_l2gd",
]
