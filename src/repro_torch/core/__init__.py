"""Core library of the port: the codec layer, compressors, the L2GD step,
the aggregation layer (stacked and sharded), the rollouts (synchronous,
client-sharded, grid and async), the extensions and the
convergence-theory calculators."""
from repro_torch.core.codec import (
    BernoulliPayload, CompressionPlan, DensePayload, NarrowQSGDPayload,
    NaturalPayload, QSGDPayload, SparsePayload, TernPayload, TreePayload,
    as_plan, decode_payload, index_bits, make_plan, plan_from_spec,
    plan_spec,
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
    compressed_average, compressed_average_wire,
    make_client_sharded_average, make_packed_sharded_average,
    make_payload_sharded_average, make_sharded_average, masked_client_mean,
    stacked_finite_mask, stochastic_round_cast, weighted_client_sum,
)
from repro_torch.core.flatbuf import (
    FlatLayout, flat_tree_apply, narrow_tree_qsgd, pack_tree,
    pack_tree_natural, pack_tree_qsgd, packed_wire_bits, payload_wire_bits,
    reduce_payload_mean, supports_fused_reduce, unpack_tree,
    unpack_tree_qsgd, widen_tree_qsgd,
)
from repro_torch.core.rollout import (
    RolloutTrace, draw_participation_mask, hyper_grid, participant_count,
    participation_masks, rollout_l2gd, rollout_l2gd_grid,
    rollout_l2gd_sharded, sharded_state_specs,
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
    "plan_from_spec", "plan_spec", "index_bits", "QSGD", "Bernoulli", "Compressor",
    "Identity", "Natural", "RandK", "TernGrad", "TopK", "make_compressor",
    "tree_apply", "tree_wire_bits", "joint_omega",
    "L2GDHyper", "L2GDState", "aggregation_update", "draw_xi", "init_state",
    "l2gd_step", "local_update", "make_hyper", "compressed_average",
    "masked_client_mean", "stacked_finite_mask", "weighted_client_sum",
    "compressed_average_wire", "stochastic_round_cast",
    "make_sharded_average", "make_payload_sharded_average",
    "make_packed_sharded_average", "make_client_sharded_average",
    "packed_wire_bits", "payload_wire_bits", "unpack_tree_qsgd",
    "FlatLayout", "flat_tree_apply", "pack_tree", "pack_tree_qsgd",
    "pack_tree_natural", "unpack_tree", "narrow_tree_qsgd",
    "widen_tree_qsgd", "reduce_payload_mean", "supports_fused_reduce",
    "RolloutTrace", "rollout_l2gd", "rollout_l2gd_grid", "hyper_grid",
    "rollout_l2gd_sharded", "sharded_state_specs",
    "participant_count", "draw_participation_mask", "participation_masks",
    "EVENT_FIELDS", "AsyncAggState", "AsyncRolloutTrace", "fault_totals",
    "init_async_state", "rollout_l2gd_async", "EFMemory", "init_ef_memory",
    "ef_average", "compress_grads", "theory",
]
