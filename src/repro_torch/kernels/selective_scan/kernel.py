"""Selective scan — the wrappers of the CUDA kernels in
``csrc/selective_scan.cu``: the forward, the counterpart of
``repro.kernels.selective_scan.kernel.selective_scan``, and its backward.

The forward takes dt, x (B, L, E) and Bm, Cm (B, L, N), contiguous, in
float32 or bfloat16 (all four alike), A (E, N) contiguous float32, any
L >= 1, any E >= 1 and N <= :data:`MAX_STATE`, and writes a contiguous
(B, L, E) y in x.dtype.  The state starts at zero, as in the reference's
kernel.  The reference's ``chunk`` and ``e_blk`` sized its tiles to VMEM
(and made callers pad L); the CUDA kernel masks its own edges and has
no such knobs.

When a backward will follow (autograd on and an operand requiring
grad), the op runs as :class:`_SelectiveScan`: the forward also writes
the float32 state at the start of every chunk of :func:`ckpt_chunk`
steps.  The backward (``selective_scan_bwd``, one call) recomputes
each chunk's states from its checkpoint and walks them in reverse,
giving the gradients of dt, Bm, Cm, x and A (float32 only: bfloat16
operands raise in the backward).  Where one walk over L a channel block
would leave the card short of blocks (:func:`bwd_plan`), L is split: a
carry pass, one thread a state over all of L, writes the adjoint's carry
into each chunk, and the chunk kernel runs one block a chunk from it.
The reference's Pallas kernel has no backward; its training
path differentiates the chunked scan of ``models/mamba.py`` with XLA.

A CUDA tensor launches the kernels (or raises); a CPU tensor runs the
plain versions in ``ref.py``, through the same autograd Function.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.dispatch import use_kernel
from repro_torch.kernels.selective_scan.ref import (selective_scan_bwd_ref,
                                                    selective_scan_ref)

__all__ = ["LANES", "MAX_STATE", "BWD_GROUPS", "WALK_GROUPS", "lane_split",
           "warps", "ckpt_chunk", "blocks", "bwd_plan", "bwd_slots",
           "bwd_blocks", "selective_scan"]

#: the largest state size N the kernel keeps in registers
MAX_STATE = 16

#: lanes of a warp a channel's states are spread over, at most (kLanes in
#: the source)
LANES = 8

#: channel groups (of 128 / lanes channels) a block of the backward's
#: chunk kernel walks in turn when L is split, and at most when it walks
#: all of L (kBwdGroups, kWalkGroups in the source)
BWD_GROUPS = 8
WALK_GROUPS = 2


def lane_split(N: int) -> tuple:
    """(lanes a channel, states a lane) at state size N, as ``Split<N>``
    in the source: the power of two at or above N, at most
    :data:`LANES`, and the states shared out over them."""
    lanes = min(LANES, 1 << (N - 1).bit_length())
    return lanes, -(-N // lanes)


def blocks(E: int, N: int) -> int:
    """The forward's blocks of 128 threads over E channels (128 / lanes
    channels each), a batch row."""
    return -(-E // (128 // lane_split(N)[0]))


def bwd_plan(B: int, E: int, N: int, slots: int) -> tuple:
    """(split, groups) of the backward on a card that holds ``slots``
    blocks of the chunk kernel at once (:func:`bwd_slots`).  One block a
    group of 128 / lanes channels and batch row, walking all of L with
    the carry in registers, needs no carry pass; where those blocks fill
    the card at once the walk runs so, ``groups`` groups a block (about
    one wave, at most WALK_GROUPS).  Where they do not (hymba-1.5b's E =
    1600 at B = 1: 100 blocks against an H100's 264) L is split: the
    carry pass, then one block a chunk and BWD_GROUPS groups."""
    walk = B * -(-E // (128 // lane_split(N)[0]))
    if walk < slots:
        return True, BWD_GROUPS
    return False, max(1, min(WALK_GROUPS, round(walk / slots)))


def bwd_blocks(E: int, N: int, groups: int) -> int:
    """The chunk kernel's blocks over E channels (``groups`` x 128 /
    lanes channels each), a batch row and chunk: its dB / dC partials a
    step."""
    return -(-E // (groups * (128 // lane_split(N)[0])))


def warps(B: int, E: int, N: int) -> int:
    """Warps a launch runs: 4 a block, over B batch rows."""
    return B * blocks(E, N) * 4


def ckpt_chunk(N: int) -> int:
    """Steps a chunk at state size N, as ``Split<N>::CHUNK``: the forward
    writes the state before every chunk, the backward walks chunk by
    chunk."""
    return min(2048 // (128 // lane_split(N)[0]), 32)


_P, _I = ctypes.c_void_p, ctypes.c_int
# dt, Bm, Cm, x, A, y, h_ckpt; bf16, B, L, E, N; stream
_SIGNATURE = (_P,) * 7 + (_I,) * 5 + (_P,)
# dt, Bm, Cm, x, A, h_ckpt, g, ddt, dx, carry, part, dA_part, dBC, dA;
# B, L, E, N, split, groups; stream
_BWD_SIGNATURE = (_P,) * 14 + (_I,) * 6 + (_P,)
# the backward's first two launches on their own (timing only): the carry
# pass (dt, Cm, A, g, carry; B, L, E, N) and the chunk kernel (dt, Bm,
# Cm, x, A, h_ckpt, carry, g, ddt, dx, part, dA_part; B, L, E, N, split,
# groups); stream
_BWD_CARRY_SIGNATURE = (_P,) * 5 + (_I,) * 4 + (_P,)
_BWD_CHUNKS_SIGNATURE = (_P,) * 12 + (_I,) * 6 + (_P,)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(dt, Bm, Cm, x, A) -> None:
    if x.dim() != 3 or dt.shape != x.shape or Bm.dim() != 3 \
            or Cm.shape != Bm.shape or Bm.shape[:2] != x.shape[:2]:
        raise ValueError(f"expected dt, x (B, L, E) and Bm, Cm (B, L, N), got "
                         f"{tuple(dt.shape)}, {tuple(x.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    N = Bm.shape[2]
    if A.shape != (x.shape[2], N):
        raise ValueError(f"A must be (E, N) = {(x.shape[2], N)}, got "
                         f"{tuple(A.shape)}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"state size N = {N} outside 1..{MAX_STATE}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (dt, Bm, Cm)):
        raise ValueError(f"dt, Bm, Cm, x must share float32 or bfloat16, got "
                         f"{dt.dtype}, {Bm.dtype}, {Cm.dtype}, {x.dtype}")
    if A.dtype != torch.float32:
        raise ValueError(f"A must be float32, got {A.dtype}")
    for t, what in ((dt, "dt"), (Bm, "Bm"), (Cm, "Cm"), (x, "x"), (A, "A")):
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")


def _launch(dt, Bm, Cm, x, A, ckpt: bool = False):
    """The forward kernel: y, or (y, h_ckpt) with ``ckpt``."""
    Bsz, L, E = x.shape
    N = Bm.shape[2]
    if Bsz > 65535:
        raise ValueError(f"batch {Bsz} exceeds the grid's 65535")
    y = torch.empty((Bsz, L, E), dtype=x.dtype, device=x.device)
    h_ckpt = torch.empty((Bsz, -(-L // ckpt_chunk(N)), E, N),
                         dtype=torch.float32, device=x.device) \
        if ckpt else None
    if y.numel():
        dispatch.launch("selective_scan", "selective_scan", _SIGNATURE,
                        x.device, dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                        x.data_ptr(), A.data_ptr(), y.data_ptr(),
                        h_ckpt.data_ptr() if ckpt else None,
                        _DTYPES[x.dtype], Bsz, L, E, N)
    return (y, h_ckpt) if ckpt else y


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(device: torch.device, N: int) -> int:
    lib = build.library("selective_scan")
    fn = lib.selective_scan_bwd_occupancy
    fn.argtypes, fn.restype = (_I, ctypes.POINTER(_I)), _I
    blocks = _I(0)
    with torch.cuda.device(device):
        err = fn(N, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"selective_scan_bwd_occupancy failed: "
                           f"cudaError_t {err}")
    return blocks.value


def bwd_slots(device, N: int) -> int:
    """Blocks of the backward's chunk kernel at state size N that the
    CUDA ``device`` holds at once: its SMs times the blocks an SM holds,
    as the CUDA runtime works them out from the built kernel."""
    device = torch.device(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * _blocks_per_sm(device, N)


def _launch_bwd(dt, Bm, Cm, x, A, h_ckpt, g, plan=None) -> tuple:
    """The backward kernels: (ddt, dBm, dCm, dx, dA), float32.  ``plan``
    (split, groups) overrides :func:`bwd_plan`'s choice for this card."""
    Bsz, L, E = x.shape
    N = Bm.shape[2]
    dev = x.device
    ddt = torch.empty((Bsz, L, E), dtype=torch.float32, device=dev)
    dx = torch.empty_like(ddt)
    dBC = torch.empty((2, Bsz, L, N), dtype=torch.float32, device=dev)
    dA = torch.empty((E, N), dtype=torch.float32, device=dev)
    if not ddt.numel():
        return ddt, dBC.zero_()[0], dBC[1], dx, dA.zero_()
    if -(-L // ckpt_chunk(N)) > 65535:
        raise ValueError(f"{-(-L // ckpt_chunk(N))} chunks of L = {L} "
                         "exceed the grid's 65535")
    split, groups = plan or bwd_plan(Bsz, E, N, bwd_slots(dev, N))
    carry, part, dA_part = _bwd_scratch(Bsz, L, E, N, split, groups, dev)
    dispatch.launch("selective_scan", "selective_scan_bwd", _BWD_SIGNATURE,
                    dev, dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                    x.data_ptr(), A.data_ptr(), h_ckpt.data_ptr(),
                    g.data_ptr(), ddt.data_ptr(), dx.data_ptr(),
                    carry.data_ptr() if split else None, part.data_ptr(),
                    dA_part.data_ptr(), dBC.data_ptr(), dA.data_ptr(), Bsz, L,
                    E, N, int(split), groups)
    return ddt, dBC[0], dBC[1], dx, dA


def _bwd_scratch(Bsz, L, E, N, split, groups, dev) -> tuple:
    """The backward's scratch, float32: the carries into each chunk (B,
    chunks, E, N) when L is split (else None), the dB / dC partials (2,
    B, L, bwd_blocks, N) and the dA partials (B, chunks or 1, E, N)."""
    chunks = -(-L // ckpt_chunk(N))
    carry = torch.empty((Bsz, chunks, E, N), dtype=torch.float32,
                        device=dev) if split else None
    part = torch.empty((2, Bsz, L, bwd_blocks(E, N, groups), N),
                       dtype=torch.float32, device=dev)
    dA_part = torch.empty((Bsz, chunks if split else 1, E, N),
                          dtype=torch.float32, device=dev)
    return carry, part, dA_part


class _SelectiveScan(torch.autograd.Function):
    """The op under autograd: the forward keeps its operands and the
    state checkpoints, the backward launches the backward kernel (CUDA)
    or runs the plain backward (CPU).  Differentiable once: a second
    derivative raises."""

    @staticmethod
    def forward(ctx, dt, Bm, Cm, x, A):
        ckpt = x.dtype == torch.float32     # the backward's only dtype
        if dt.is_cuda:
            out = _launch(dt, Bm, Cm, x, A, ckpt=ckpt)
        else:
            out = selective_scan_ref(
                dt, Bm, Cm, x, A,
                ckpt_chunk=ckpt_chunk(Bm.shape[2]) if ckpt else None)
        y, h_ckpt = out if ckpt else (out, None)
        ctx.save_for_backward(dt, Bm, Cm, x, A, h_ckpt)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        dt, Bm, Cm, x, A, h_ckpt = ctx.saved_tensors
        if h_ckpt is None:
            raise NotImplementedError(
                f"the selective-scan backward takes float32 operands only "
                f"(training runs in float32), got {x.dtype}")
        g = grad_out.float().contiguous()
        if g.is_cuda:
            return _launch_bwd(dt, Bm, Cm, x, A, h_ckpt, g)
        return selective_scan_bwd_ref(dt, Bm, Cm, x, A, h_ckpt, g,
                                      ckpt_chunk(Bm.shape[2]))


def selective_scan(dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                   x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """dt / x: (B, L, E); Bm / Cm: (B, L, N); A: (E, N) float32.  Returns
    y (B, L, E) in x.dtype, from a zero state; differentiable in all five
    operands (float32)."""
    _check(dt, Bm, Cm, x, A)
    kernel = use_kernel(dt, Bm, Cm, x, A)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dt, Bm, Cm, x, A)):
        return _SelectiveScan.apply(dt, Bm, Cm, x, A)
    return _launch(dt, Bm, Cm, x, A) if kernel \
        else selective_scan_ref(dt, Bm, Cm, x, A)
