"""The yardstick's arithmetic: the H100's peaks, a training step's FLOPs
and the codec's least bytes.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the 700 W limit): 67
TFLOP/s float32 outside the tensor cores (the cells run float32 with
TF32 off) and 3.35 TB/s of HBM3.

FLOPs of one client's training step on B x S tokens (the analytic count
of the repository's ``launch.roofline``, frozen here): 6 N_active a
token for the products (forward 2, backward 4), plus 3 x 4 B S^2 H hd /
2 a layer for the causal attention's score and value products.  N_active
counts the table once (the tied unembedding's product) and k of E
experts a layer; recomputed forwards are not counted.

Codec bytes of one fresh round: every client's model read once and the
target written once, (n + 1) x 4 bytes an element.  Whatever implements
the compressed average has to move at least that.
"""
from __future__ import annotations

import math

PEAK_F32 = 67e12
HBM_BW = 3.35e12


def active_params(cfg: dict, shapes: dict) -> float:
    total = 0.0
    for name, shape in shapes.items():
        size = math.prod(shape)
        if cfg["ffn"] == "moe" and name in ("layers.ffn.w_gate",
                                            "layers.ffn.w_up",
                                            "layers.ffn.w_down"):
            size = size * cfg["experts_per_token"] / cfg["n_experts"]
        total += size
    return total


def train_flops(cfg: dict, shapes: dict) -> float:
    """FLOPs of one local step of all clients."""
    B, S = cfg["batch_per_client"], cfg["seq_len"]
    attention = cfg["n_layers"] * 4.0 * B * S * S * cfg["n_heads"] \
        * cfg["head_dim"] * 0.5
    per_client = 6.0 * active_params(cfg, shapes) * B * S + 3.0 * attention
    return cfg["clients"] * per_client


def codec_bytes(cfg: dict, shapes: dict) -> float:
    """Least bytes of one fresh round's compressed average."""
    d = sum(math.prod(s) for s in shapes.values())
    return (cfg["clients"] + 1) * 4.0 * d
