"""Build and load the port's CUDA kernels.

Each kernel source under ``kernels/*/csrc/`` has a plain C interface and
is compiled by ``nvcc`` into its own shared library, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds, not minutes).
Libraries go to ``build/`` at the repository root (git-ignored), named by
a hash of the source and the flags, so an edited source is never served
from a stale build.  A failed build raises.

:func:`build_all` starts one ``nvcc`` per source at once and waits for
all of them; :func:`library` builds on first use and loads.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCES", "NVCC_FLAGS", "build_all", "library"]

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build"

#: library name -> CUDA source, relative to repro_torch/kernels
SOURCES = {"qsgd": "qsgd/csrc/qsgd.cu",
           "natural": "natural/csrc/natural.cu",
           "flash_attention": "flash_attention/csrc/flash_attention.cu",
           "selective_scan": "selective_scan/csrc/selective_scan.cu",
           "threefry": "threefry/csrc/threefry.cu"}

# --fmad=false: the kernels' parity contract forbids contracting a
# multiply and an add into one FMA (DESIGN.md §6 rounding order)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LOADED: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _target(name: str) -> tuple:
    src = _KERNELS / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return src, BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names=None) -> dict:
    """Compile every named source (default: all) that has no current
    build, one ``nvcc`` process each, all started together.  Returns
    {name: library path}; raises with the compiler's output on failure."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in names}
    procs = {}
    for name, (src, out) in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {SOURCES[name]} "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: out for name, (_, out) in targets.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built on first use."""
    if name not in _LOADED:
        path = build_all([name])[name]
        _LOADED[name] = ctypes.CDLL(str(path))
    return _LOADED[name]
