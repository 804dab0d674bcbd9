"""The yardstick's arithmetic that every model shares: the H100's peaks
and the codec's least bytes.  A training step's FLOPs are the plain
model's (``train_flops`` of the configuration's ``reference`` module).

Peaks (NVIDIA's H100 SXM data sheet, dense, at the 700 W limit): 67
TFLOP/s float32 outside the tensor cores (the cells run float32 with
TF32 off) and 3.35 TB/s of HBM3.

Codec bytes of one fresh round: every client's model read once and the
target written once, (n + 1) x 4 bytes an element.  Whatever implements
the compressed average has to move at least that.
"""
from __future__ import annotations

import math

PEAK_F32 = 67e12
HBM_BW = 3.35e12


def codec_bytes(cfg: dict, shapes: dict) -> float:
    """Least bytes of one fresh round's compressed average."""
    d = sum(math.prod(s) for s in shapes.values())
    return (cfg["clients"] + 1) * 4.0 * d
