"""Threefry-2x32 array draws — the wrapper of the CUDA kernel in
``csrc/threefry.cu``, behind ``repro_torch.core.prng``'s array draws
(``tensor_bits``, ``tensor_uniform``, ``tensor_bernoulli`` and the
uniform under ``tensor_normal``).

  threefry_draw — hash counters ``offset`` .. ``offset + total - 1`` with
                  each key of a batch and write the finished draw (the
                  bits, their uniform, or a bernoulli of it) into a
                  (batch, total) output, in one launch

``prng._draw`` calls it for a CUDA output and runs the plain version,
``prng._draw_plain``, for a CPU one (the rule of
:mod:`repro_torch.kernels.dispatch`); this wrapper launches or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import dispatch

__all__ = ["FINISHES", "threefry_draw"]

#: the kernel's finishes: name -> (its mode argument, the output dtype)
FINISHES = {"bits": (0, torch.int64), "uniform": (1, torch.float32),
            "bernoulli": (2, torch.bool)}

_SIGNATURE = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
              ctypes.c_int64, ctypes.c_uint64, ctypes.c_int, ctypes.c_float,
              ctypes.c_void_p)


def threefry_draw(keys, out: torch.Tensor, offset: int, finish: str,
                  p: float = 0.0) -> None:
    """Fill ``out`` (batch, total), contiguous on a CUDA device and of the
    finish's dtype, with the draw of ``keys`` (batch, 2) uint32 words at
    counters ``offset`` .. ``offset + total - 1`` (within 2^64: ``prng.
    _draw`` checks); ``p`` is the bernoulli's float32 probability.  The
    keys reach the device by an asynchronous copy from pinned memory: no
    host synchronization."""
    mode, dtype = FINISHES[finish]
    words = np.ascontiguousarray(keys, np.uint32)
    if out.device.type != "cuda":
        raise ValueError(f"threefry_draw launches on a CUDA tensor, got "
                         f"{out.device}")
    if out.dtype != dtype or out.dim() != 2 or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous {dtype} (batch, total) "
                         f"tensor, got {out.dtype} {tuple(out.shape)}")
    if words.shape != (out.shape[0], 2):
        raise ValueError(f"keys {words.shape} do not match out "
                         f"{tuple(out.shape)}")
    batch, total = out.shape
    if not out.numel():
        return
    keys_dev = torch.from_numpy(words.view(np.int32)).pin_memory() \
        .to(out.device, non_blocking=True)
    dispatch.launch("threefry", "threefry_draw", _SIGNATURE, out.device,
                    keys_dev.data_ptr(), out.data_ptr(), batch, total,
                    int(offset), mode, float(p))
