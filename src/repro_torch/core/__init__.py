"""Core library of the port: the codec layer, compressors, the L2GD step,
the aggregation layer and the rollout."""
from repro_torch.core.codec import (
    BernoulliPayload, CompressionPlan, DensePayload, NarrowQSGDPayload,
    NaturalPayload, QSGDPayload, SparsePayload, TernPayload, TreePayload,
    as_plan, decode_payload, make_plan, plan_from_spec, plan_spec,
)
from repro_torch.core.compressors import (
    QSGD, Bernoulli, Compressor, Identity, Natural, RandK, TernGrad, TopK,
    make_compressor,
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
    "BernoulliPayload", "CompressionPlan", "DensePayload",
    "NarrowQSGDPayload", "NaturalPayload", "QSGDPayload", "SparsePayload",
    "TernPayload", "TreePayload", "as_plan", "decode_payload", "make_plan",
    "plan_from_spec", "plan_spec", "QSGD", "Bernoulli", "Compressor",
    "Identity", "Natural", "RandK", "TernGrad", "TopK", "make_compressor",
    "L2GDHyper", "L2GDState", "aggregation_update", "draw_xi", "init_state",
    "l2gd_step", "local_update", "compressed_average", "masked_client_mean",
    "stacked_finite_mask", "weighted_client_sum", "RolloutTrace",
    "rollout_l2gd",
]
