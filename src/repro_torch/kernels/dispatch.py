"""Device dispatch for the port's kernels — the counterpart of
``repro.kernels.dispatch``.

The JAX package chose between a compiled Pallas kernel and its jnp
fallback from the backend (``on_tpu``) and sized tiles to VMEM
(``autotune_rows``).  The port's rule reads the tensors themselves:

  * a CUDA tensor goes to the hand-written CUDA kernel, or the call
    raises — a wrapper never falls back to its plain version on the card;
  * a CPU tensor goes to the plain PyTorch version (the tests' path);
  * any other device raises.

Every wrapper counts its launches in :data:`LAUNCHES` at the point where
it launches its kernel and nowhere else, so a run can show that its main
path went through the kernels (``chip_smoke.py`` resets and reads them).
:data:`LAUNCHES` is the ``launches`` group of ``repro_torch.tracing``'s
counters.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch import tracing
from repro_torch.kernels import build

__all__ = ["LAUNCHES", "reset_launches", "use_kernel", "resolve_device",
           "launch"]

#: kernel name -> number of launches since the last reset
LAUNCHES: collections.Counter = tracing.counter("launches")


def reset_launches() -> None:
    LAUNCHES.clear()


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on a CUDA device (launch the kernel),
    False when they lie on the CPU (run the plain version).  Tensors on
    different devices, or on any other device, raise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel operands span devices {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel and no plain version for device {device}")


def resolve_device(device=None) -> torch.device:
    """The device of an entry point: ``cuda`` unless the caller names
    another (the tests pass ``"cpu"``).  With no CUDA device and no
    explicit choice this raises instead of carrying on on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; pass "
                "device='cpu' to run the plain PyTorch versions")
        return torch.device("cuda")
    return torch.device(device)


def launch(library: str, name: str, argtypes: tuple, device: torch.device,
           *args) -> None:
    """Call kernel ``name`` of ``library`` (a ``build.SOURCES`` key) on
    PyTorch's current stream of ``device``; raise if its launch was
    refused, count it otherwise.  ``argtypes`` is the ctypes signature
    of the C entry point, the trailing stream included."""
    fn = getattr(build.library(library), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    LAUNCHES[name] += 1
