"""Core library of the port: the codec layer, compressors, the L2GD step,
the aggregation layer, the rollouts (synchronous, grid and async), the
extensions and the convergence-theory calculators."""
from repro_torch.core.codec import (
    BernoulliPayload, CompressionPlan, DensePayload, NarrowQSGDPayload,
    NaturalPayload, QSGDPayload, SparsePayload, TernPayload, TreePayload,
    as_plan, decode_payload, make_plan, plan_from_spec, plan_spec,
)
from repro_torch.core.compressors import (
    QSGD, Bernoulli, Compressor, Identity, Natural, RandK, TernGrad, TopK,
    joint_omega, make_compressor, tree_apply, tree_wire_bits,
)
from repro_torch.core.l2gd import (
    L2GDHyper, L2GDState, aggregation_update, draw_xi, init_state, l2gd_step,
    local_update, make_hyper,
)
from repro_torch.core.aggregation import (
    compressed_average, masked_client_mean, stacked_finite_mask,
    weighted_client_sum,
)
from repro_torch.core.flatbuf import (
    packed_wire_bits, payload_wire_bits, unpack_tree_qsgd,
)
from repro_torch.core.rollout import (
    RolloutTrace, draw_participation_mask, hyper_grid, participant_count,
    participation_masks, rollout_l2gd, rollout_l2gd_grid,
)
from repro_torch.core.async_engine import (
    EVENT_FIELDS, AsyncAggState, AsyncRolloutTrace, fault_totals,
    init_async_state, rollout_l2gd_async,
)
from repro_torch.core.extensions import (
    EFMemory, compress_grads, ef_average, init_ef_memory,
)
from repro_torch.core import theory

__all__ = [
    "BernoulliPayload", "CompressionPlan", "DensePayload",
    "NarrowQSGDPayload", "NaturalPayload", "QSGDPayload", "SparsePayload",
    "TernPayload", "TreePayload", "as_plan", "decode_payload", "make_plan",
    "plan_from_spec", "plan_spec", "QSGD", "Bernoulli", "Compressor",
    "Identity", "Natural", "RandK", "TernGrad", "TopK", "make_compressor",
    "tree_apply", "tree_wire_bits", "joint_omega",
    "L2GDHyper", "L2GDState", "aggregation_update", "draw_xi", "init_state",
    "l2gd_step", "local_update", "make_hyper", "compressed_average",
    "masked_client_mean", "stacked_finite_mask", "weighted_client_sum",
    "packed_wire_bits", "payload_wire_bits", "unpack_tree_qsgd",
    "RolloutTrace", "rollout_l2gd", "rollout_l2gd_grid", "hyper_grid",
    "participant_count", "draw_participation_mask", "participation_masks",
    "EVENT_FIELDS", "AsyncAggState", "AsyncRolloutTrace", "fault_totals",
    "init_async_state", "rollout_l2gd_async", "EFMemory", "init_ef_memory",
    "ef_average", "compress_grads", "theory",
]
