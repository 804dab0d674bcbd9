"""Analytic roofline terms on the NVIDIA H100 — the counterpart of the
analytic half of ``repro.launch.roofline``.

Hardware model, one H100 SXM (NVIDIA's H100 data sheet, dense rates at
the 700 W power limit):

  * ``PEAK_FLOPS``: 67e12 FLOP/s float32 outside the tensor cores (the
    port's default: TF32 off), 989e12 bfloat16 on the tensor cores;
  * ``HBM_BW`` = 3.35e12 B/s;
  * ``LINK_BW`` = 450e9 B/s: NVLink 4, 900 GB/s to the other cards of
    the host all to all, i.e. 450 GB/s each way.

The compute term's numerator is the ANALYTIC FLOP count (matmuls 2 x
N_active a token, the attention score/value terms, the SSM scan term;
x3 for training).  The reference also parses XLA's optimized HLO for
its collective schedule (``_split_computations`` / ``collective_stats``);
the port has no compiled graph to parse, and its dry run
(``launch.dryrun``) counts the aggregation collective from the plans'
``round_bits()`` instead.
"""
from __future__ import annotations

from typing import Dict

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "roofline_terms",
           "model_flops", "analytic_flops"]

#: H100 SXM peak FLOP/s by compute dtype (NVIDIA data sheet, dense)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
#: H100 SXM HBM3 bandwidth, B/s
HBM_BW = 3.35e12
#: NVLink 4 per direction (900 GB/s bidirectional), B/s
LINK_BW = 450e9


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   wire_bytes_per_dev: float,
                   dtype: str = "float32") -> Dict:
    """Seconds of compute, memory and collective at the H100's peaks,
    and which of the three dominates."""
    t_c = flops_per_dev / PEAK_FLOPS[dtype]
    t_m = bytes_per_dev / HBM_BW
    t_x = wire_bytes_per_dev / LINK_BW
    dominant = max(("compute", t_c), ("memory", t_m), ("collective", t_x),
                   key=lambda kv: kv[1])[0]
    return {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
            "dominant": dominant}


def model_flops(n_params_active: float, tokens: float) -> float:
    """MODEL_FLOPS = 6 * N * D (dense) / 6 * N_active * D (MoE)."""
    return 6.0 * n_params_active * tokens


def analytic_flops(cfg, shape, n_params_active: float) -> float:
    """Global FLOPs for one step: matmul (2 N_active a token) + attention
    score/value terms + SSM scan term; training multiplies by 3 (the
    backward about twice the forward)."""
    from repro_torch.models.model import layer_kinds
    S, B = shape.seq_len, shape.global_batch
    kind = shape.kind
    tokens = B * S if kind != "decode" else B
    total = 2.0 * n_params_active * tokens
    kinds = layer_kinds(cfg)
    H, hd = cfg.n_heads, cfg.hd
    if cfg.mixer in ("gqa", "mla", "hybrid"):
        for k in kinds:
            if kind == "decode":
                ctx = min(S, cfg.sliding_window or S) if not k.is_global \
                    else S
                total += 4.0 * B * ctx * H * hd
            elif k.is_global or cfg.sliding_window is None:
                total += 4.0 * B * S * S * H * hd * 0.5   # causal half
            else:
                total += 4.0 * B * S * cfg.sliding_window * H * hd
    if cfg.is_encdec:
        F = cfg.n_frontend_tokens
        total += cfg.encoder_layers * 4.0 * B * F * F * H * hd   # enc self
        total += cfg.n_layers * 4.0 * B * (S if kind != "decode" else 1) \
            * F * H * hd                                         # cross
    if cfg.mixer in ("mamba", "hybrid"):
        E = cfg.ssm_expand * cfg.d_model
        total += cfg.n_layers * 10.0 * tokens * E * cfg.ssm_state
    if kind == "train":
        total *= 3.0
    return total
