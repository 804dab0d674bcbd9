"""Parity of the port's selective scan with the JAX reference: the plain
PyTorch version (which the CUDA kernel is held to on the card) against
the reference's jitted ``selective_scan_ref``, its Pallas kernel in
interpret mode through ``selective_scan_op``, and the Mamba mixer's
chunked scan; the CPU route of the wrapper and of the op; the wrapper's
checks; the kernel source in the build.  The backward: the plain
backward (which the backward kernel is held to on the card) against
``jax.vjp`` of the reference's scan and torch autograd of the plain
forward, the forward's state checkpoints, the autograd Function's glue
on the CPU route, and the backward kernels' order emulated (a carry
pass over all of L, then every chunk on its own) against both.

Inputs are drawn with numpy as tests/test_kernels.py draws them with
jax.random: dt = softplus(normal) * 0.2, B, C and x normal, A = -|normal|.

Tolerances: float32 ``rtol = 1e-4, atol = 1e-5``, the reference's own
bound between its kernel and its oracle (tests/test_kernels.py); the
plain version agrees with the jitted oracle far closer (each test states
the measured bound: torch's and XLA's exp differ in the last bit, and
the difference carries along the recurrence).  bf16: the reference's
5e-2.
"""
import pathlib
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_threads import torch_one_thread  # noqa: F401
from repro.kernels.selective_scan.ops import \
    selective_scan_op as jscan_op
from repro.kernels.selective_scan.ref import \
    selective_scan_ref as jscan_ref
from repro.models.mamba import selective_scan_chunked as jscan_chunked
from repro_torch.kernels import build
from repro_torch.kernels.selective_scan import kernel as sk
from repro_torch.kernels.selective_scan.kernel import (MAX_STATE,
                                                       selective_scan)
from repro_torch.kernels.selective_scan.ops import selective_scan_op
from repro_torch.kernels.selective_scan.ref import (selective_scan_bwd_ref,
                                                    selective_scan_ref)

RTOL, ATOL = 1e-4, 1e-5
BF16_TOL = 5e-2
#: the plain version against the jitted oracle, relative to max(1, max|y|):
#: at most 3.1e-7, measured with jax 0.9.0 and torch 2.13 on the CPU
PLAIN_TOL = 1e-6

_jref = jax.jit(jscan_ref)

# the reference's sweep (tests/test_kernels.py) with its tiles, and the
# mixer's ragged shape (tests/test_models_smoke.py)
SWEEP = [
    (1, 16, 8, 4, 8, 8), (2, 64, 32, 16, 16, 16), (1, 100, 48, 16, 32, 16),
    (3, 33, 16, 8, 16, 8), (2, 37, 24, 8, 16, 8),
]


def _inputs(B, L, E, N, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    dt = np.logaddexp(rng.normal(size=(B, L, E)), 0.0) * 0.2
    Bm = rng.normal(size=(B, L, N))
    Cm = rng.normal(size=(B, L, N))
    x = rng.normal(size=(B, L, E))
    A = -np.abs(rng.normal(size=(E, N)))
    return (dt.astype(dtype), Bm.astype(dtype), Cm.astype(dtype),
            x.astype(dtype), A.astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))
                 / max(1.0, float(np.max(np.abs(want)))))


@pytest.mark.parametrize("B,L,E,N,chunk,eblk", SWEEP)
def test_plain_matches_jitted_reference(B, L, E, N, chunk, eblk):
    ins = _inputs(B, L, E, N, seed=L)
    want = np.asarray(_jref(*ins))
    got = selective_scan_ref(*_t(*ins)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert _rel(got, want) < PLAIN_TOL


@pytest.mark.parametrize("B,L,E,N,chunk,eblk", SWEEP[:4])
def test_plain_matches_pallas_interpret(B, L, E, N, chunk, eblk):
    ins = _inputs(B, L, E, N, seed=L + 1)
    want = np.asarray(jscan_op(*ins, chunk=chunk, e_blk=eblk,
                               interpret=True))
    got = selective_scan_op(*_t(*ins)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert _rel(got, want) < PLAIN_TOL


def test_bf16_matches_pallas_interpret():
    """bf16 inputs, float32 A: the plain version against the Pallas kernel
    (interpret mode) at the reference's bf16 bound, and against the
    float32 result of the same bf16 values within one bf16 rounding."""
    B, L, E, N = 1, 32, 16, 8
    ins = _inputs(B, L, E, N, seed=5)
    jins = [jnp.asarray(a).astype(jnp.bfloat16) for a in ins[:4]]
    want = np.asarray(jscan_op(*jins, ins[4], chunk=16, e_blk=16,
                               interpret=True).astype(jnp.float32))
    tins = [torch.from_numpy(np.array(a.astype(jnp.float32)))
            .to(torch.bfloat16) for a in jins]
    got = selective_scan_op(*tins, torch.from_numpy(ins[4]))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_TOL,
                               atol=BF16_TOL)
    f32 = selective_scan_ref(*[t.float() for t in tins],
                             torch.from_numpy(ins[4]))
    assert torch.equal(got, f32.to(torch.bfloat16))


def test_plain_matches_reference_chunked_scan():
    """The Mamba mixer's chunked associative scan (the reference's
    training path) at the ragged shape of tests/test_models_smoke.py."""
    B, L, E, N = 2, 37, 24, 8
    ins = _inputs(B, L, E, N, seed=9)
    want, _ = jax.jit(jscan_chunked, static_argnames="chunk")(
        *ins, np.zeros((B, E, N), np.float32), chunk=8)
    got = selective_scan_ref(*_t(*ins)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    assert _rel(got, want) < PLAIN_TOL


# --------------------------------------------------------------------------
# the CUDA kernel's order of y's N-term sum, emulated
# --------------------------------------------------------------------------

#: chip_smoke.py's bound between the kernel and its plain version: 16
#: float32 ulps of max |y| (the two differ only in the order of y's sum)
SCAN_ULPS = 16


def _tree_sum(terms):
    """Sum over the last axis (N) in the kernel's order: lane j of a
    channel's group adds its states j*SPL .. j*SPL+SPL-1 in order, then
    the lanes' partials meet in the xor tree of offsets LANES/2, ..., 1
    (states past N are zero)."""
    N = terms.shape[-1]
    lanes, spl = sk.lane_split(N)
    pad = lanes * spl - N
    t = torch.nn.functional.pad(terms, (0, pad)).reshape(
        *terms.shape[:-1], lanes, spl)
    part = t[..., 0]
    for s in range(1, spl):
        part = part + t[..., s]
    while part.shape[-1] > 1:
        half = part.shape[-1] // 2
        part = part[..., :half] + part[..., half:]
    return part[..., 0]


def _tree_scan(dt, Bm, Cm, x, A):
    """The plain version's state trajectory with y summed as the kernel
    sums it."""
    h = torch.zeros((x.shape[0], x.shape[2], A.shape[1]))
    ys = torch.empty(x.shape)
    for t in range(x.shape[1]):
        dt_t = dt[:, t]
        decay = torch.exp(dt_t[..., None] * A[None])
        drive = (dt_t * x[:, t])[..., None] * Bm[:, t, None, :]
        h = decay * h + drive
        ys[:, t] = _tree_sum(h * Cm[:, t, None, :])
    return ys


def test_lane_split_matches_the_source():
    """kernel.py's copy of the source's Split<N>: lanes a channel, states
    a lane, and the warps at the prefill shapes."""
    src = (pathlib.Path(build.__file__).parent
           / build.SOURCES["selective_scan"]).read_text()
    assert f"constexpr int kLanes = {sk.LANES};" in src
    assert [sk.lane_split(n) for n in (1, 2, 3, 5, 8, 9, 12, 16)] == [
        (1, 1), (2, 1), (4, 1), (8, 1), (8, 1), (8, 2), (8, 2), (8, 2)]
    assert sk.warps(2, 8192, 16) == 4096      # falcon-mamba-7b
    assert sk.warps(2, 1600, 16) == 800       # hymba-1.5b
    # at N = 16 two states a lane, p_j = t_2j + t_2j+1, then
    # ((p0 + p4) + (p2 + p6)) + ((p1 + p5) + (p3 + p7)): 2^24 + 1 is lost
    # where the order puts 1 beside 2^24 alone
    t = torch.zeros(16)
    t[0], t[1], t[8] = 2.0 ** 24, 1.0, 1.0
    assert float(_tree_sum(t)) == 2.0 ** 24
    t[1], t[9] = 0.0, 1.0
    assert float(_tree_sum(t)) == 2.0 ** 24 + 2


@pytest.mark.parametrize("B,L,E,N,chunk,eblk",
                         SWEEP + [(2, 40, 1600, 16, 16, 64)])
def test_kernel_sum_order_holds_the_ulp_bound(B, L, E, N, chunk, eblk):
    """The kernel's y (the plain trajectory, y's sum in its tree order)
    against the Pallas kernel in interpret mode and against the plain
    version, within SCAN_ULPS float32 ulps of max |y|; the sweep and
    hymba-1.5b's E = 1600."""
    ins = _inputs(B, L, E, N, seed=L + 2)
    want = np.asarray(jscan_op(*ins, chunk=chunk, e_blk=eblk,
                               interpret=True))
    got = _tree_scan(*_t(*ins)).numpy()
    plain = selective_scan_ref(*_t(*ins)).numpy()
    for ref in (want, plain):
        ulp = float(np.spacing(np.float32(np.max(np.abs(ref)))))
        assert np.max(np.abs(got - ref)) <= SCAN_ULPS * ulp


def test_cpu_route_takes_the_plain_version():
    ins = _t(*_inputs(2, 20, 12, 16, seed=3))
    want = selective_scan_ref(*ins)
    assert torch.equal(selective_scan(*ins), want)
    assert torch.equal(selective_scan_op(*ins), want)
    # the op hands the kernel contiguous operands: B and C as column
    # slices of one projection, as the Mamba mixer makes them
    dbc = torch.cat([ins[1], ins[2]], dim=-1)
    got = selective_scan_op(ins[0], dbc[..., :16], dbc[..., 16:], ins[3],
                            ins[4])
    assert torch.equal(got, want)
    assert selective_scan(*[t[:, :0] for t in ins[:4]], ins[4]).shape \
        == (2, 0, 12)


@pytest.mark.parametrize("bad", ["dtype", "mixed", "A_dtype", "shape",
                                 "A_shape", "state", "strided"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    dt, Bm, Cm, x, A = _t(*_inputs(1, 8, 4, 2))
    if bad == "dtype":
        dt, Bm, Cm, x = (t.half() for t in (dt, Bm, Cm, x))
    elif bad == "mixed":
        dt = dt.to(torch.bfloat16)
    elif bad == "A_dtype":
        A = A.double()
    elif bad == "shape":
        dt = dt[:, :7]
    elif bad == "A_shape":
        A = A[:3]
    elif bad == "state":
        Bm = Cm = torch.zeros((1, 8, MAX_STATE + 1))
        A = torch.zeros((4, MAX_STATE + 1))
    else:
        x = torch.zeros((1, 8, 8))[..., ::2]
    with pytest.raises(ValueError):
        selective_scan(dt, Bm, Cm, x, A)


def test_other_devices_raise():
    dt, Bm, Cm, x, A = (t.to("meta") for t in _t(*_inputs(1, 8, 4, 2)))
    with pytest.raises(ValueError, match="device"):
        selective_scan(dt, Bm, Cm, x, A)


def test_cpu_route_gradient_matches_the_reference():
    """The CPU route's gradient in all five operands (the autograd
    Function with the plain forward and backward) against jax.grad of
    the reference's scan."""
    ins = _inputs(1, 12, 6, 4, seed=11)
    tins = [t.requires_grad_() for t in _t(*ins)]
    selective_scan(*tins).sum().backward()
    want = jax.grad(lambda *a: jnp.sum(jscan_ref(*a)),
                    argnums=(0, 1, 2, 3, 4))(*ins)
    for t, g in zip(tins, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=RTOL,
                                   atol=ATOL)


# --------------------------------------------------------------------------
# the backward: checkpoints, the plain backward, the Function's glue
# --------------------------------------------------------------------------

#: the plain backward against jax.vjp of the reference's jitted scan and
#: against torch autograd of the plain forward, relative to each
#: gradient's largest magnitude: GRAD_RTOL of tests/test_torch_train.py
#: (measured here at most 4e-7 against jax, where the two exps differ in
#: the last bit; torch autograd runs the same roundings, and only dA's sum
#: over the batch runs in another order)
BWD_RTOL = 2e-5

#: the sweep, hymba-1.5b's E = 1600 with ragged L and E, and every lane
#: split (N = 1 takes 16-step chunks, the others 32)
BWD_CASES = [(1, 16, 8, 4), (2, 64, 32, 16), (3, 33, 16, 8), (2, 37, 24, 8),
             (1, 70, 1605, 16), (2, 45, 130, 1), (1, 9, 5, 3), (2, 40, 20, 12)]


def _bwd_inputs(B, L, E, N, seed):
    dt, Bm, Cm, x, A = _inputs(B, L, E, N, seed=seed)
    g = np.random.default_rng(seed + 100).normal(size=(B, L, E)) \
        .astype(np.float32)
    return (dt, Bm, Cm, x, A), g


def _plain_bwd(ins, g):
    tins = _t(*ins)
    chunk = sk.ckpt_chunk(ins[1].shape[2])
    _, h = selective_scan_ref(*tins, ckpt_chunk=chunk)
    return selective_scan_bwd_ref(*tins, h, torch.from_numpy(g), chunk)


@pytest.mark.parametrize("B,L,E,N", BWD_CASES)
def test_plain_backward_matches_jax_vjp(B, L, E, N):
    ins, g = _bwd_inputs(B, L, E, N, seed=L + E)
    _, vjp = jax.vjp(_jref, *ins)
    want = vjp(g)
    got = _plain_bwd(ins, g)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        assert _rel_max(a, w) <= BWD_RTOL


@pytest.mark.parametrize("B,L,E,N", BWD_CASES[:4] + BWD_CASES[5:])
def test_plain_backward_matches_torch_autograd(B, L, E, N):
    ins, g = _bwd_inputs(B, L, E, N, seed=L + E + 1)
    tins = [t.requires_grad_() for t in _t(*ins)]
    want = torch.autograd.grad(selective_scan_ref(*tins), tins,
                               torch.from_numpy(g))
    got = _plain_bwd(ins, g)
    for a, w in zip(got[:4], want[:4]):
        assert torch.equal(a, w)
    assert _rel_max(got[4], want[4]) <= BWD_RTOL


def _rel_max(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-30))


@pytest.mark.parametrize("N", [1, 3, 16])
def test_checkpoints_are_the_plain_trajectory(N):
    """h_ckpt[:, k] is the state before step k * chunk: zero first, then
    the trajectory of the step-by-step recurrence; y is unchanged."""
    B, L, E = 2, 75, 6
    dt, Bm, Cm, x, A = _t(*_inputs(B, L, E, N, seed=N))
    chunk = sk.ckpt_chunk(N)
    assert chunk == (16 if N == 1 else 32)
    y, h = selective_scan_ref(dt, Bm, Cm, x, A, ckpt_chunk=chunk)
    assert torch.equal(y, selective_scan_ref(dt, Bm, Cm, x, A))
    assert h.shape == (B, -(-L // chunk), E, N) and h.dtype == torch.float32
    state = torch.zeros((B, E, N))
    for t in range(L):
        if t % chunk == 0:
            assert torch.equal(h[:, t // chunk], state)
        decay = torch.exp(dt[:, t, :, None] * A[None])
        state = decay * state + (dt[:, t] * x[:, t])[..., None] \
            * Bm[:, t, None, :]


def test_function_glue_on_the_cpu_route():
    """The CPU route of the op under autograd: the plain forward's
    checkpoints and the plain backward reach the operands (dA to A's
    parent too), only for operands that require grad; without autograd
    no checkpoint is made."""
    ins, g = _bwd_inputs(2, 40, 10, 16, seed=21)
    A_log = torch.log(-torch.from_numpy(ins[4])).requires_grad_()
    ins = ins[:4] + (-torch.exp(A_log.detach()).numpy(),)
    want = _plain_bwd(ins, g)
    dt, Bm, Cm, x, _ = _t(*ins)
    dbc = torch.cat([Bm, Cm], -1).requires_grad_()
    x.requires_grad_()
    y = selective_scan_op(dt, dbc[..., :16], dbc[..., 16:], x,
                          -torch.exp(A_log))
    y.backward(torch.from_numpy(g))
    assert dt.grad is None
    assert torch.equal(x.grad, want[3])
    assert torch.equal(dbc.grad, torch.cat([want[1], want[2]], -1))
    assert torch.equal(A_log.grad, want[4] * -torch.exp(A_log.detach()))
    with torch.no_grad():
        assert torch.equal(selective_scan(*_t(*ins)), y.detach())


def test_bf16_backward_raises():
    dt, Bm, Cm, x, A = (t.to(torch.bfloat16) for t in _t(*_inputs(1, 8, 4, 2)))
    x.requires_grad_()
    y = selective_scan(dt, Bm, Cm, x, _t(_inputs(1, 8, 4, 2)[4])[0])
    assert y.dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="float32"):
        y.float().sum().backward()


# --------------------------------------------------------------------------
# the backward kernels' order, emulated: the carry pass, then the chunks
# --------------------------------------------------------------------------

def _carry_pass(dt, Cm, A, g, chunk):
    """The carry pass written out: one walk over t = L-1 .. chunk of
    dh = g·C + carry, carry = decay·dh, rounded as the plain backward
    rounds.  Returns the carry that enters each chunk's reverse walk,
    (B, chunks, E, N), zero for the last chunk."""
    Bsz, L, E = dt.shape
    chunks = -(-L // chunk)
    out = torch.empty((Bsz, chunks, E, A.shape[1]))
    carry = torch.zeros((Bsz, E, A.shape[1]))
    out[:, chunks - 1] = carry
    for t in reversed(range(chunk, L)):
        dh = g[:, t, :, None] * Cm[:, t, None, :] + carry
        carry = torch.exp(dt[:, t, :, None] * A[None]) * dh
        if t % chunk == 0:
            out[:, t // chunk - 1] = carry
    return out


def _chunked_bwd(dt, Bm, Cm, x, A, h_ckpt, g, chunk, split):
    """The backward in the kernels' order.  ``split``: the carry pass
    over all of L, then each chunk on its own, its states recomputed
    from its checkpoint and walked backwards from its carry, dA summed
    over the chunk's steps (the last first) into a partial, and the
    partials summed over (b, chunk) in index order.  Else one walk over
    the chunks, last first, with the carry and dA kept between them, and
    dA's partials summed over b.  The products and the sums over n and e
    are the plain backward's, so only dA's order can differ."""
    Bsz, L, E = x.shape
    N = A.shape[1]
    chunks = -(-L // chunk)
    carries = _carry_pass(dt, Cm, A, g, chunk) if split else None
    ddt, dx = torch.empty((Bsz, L, E)), torch.empty((Bsz, L, E))
    dB, dC = torch.empty((Bsz, L, N)), torch.empty((Bsz, L, N))
    dA_part = torch.empty((Bsz, chunks if split else 1, E, N))
    carry = dA = torch.zeros((Bsz, E, N))
    for k in reversed(range(chunks)):  # split: any order, each chunk alone
        t0, t1 = k * chunk, min(L, (k + 1) * chunk)
        hs = [h_ckpt[:, k]]
        for t in range(t0, t1):
            decay = torch.exp(dt[:, t, :, None] * A[None])
            drive = (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
            hs.append(decay * hs[-1] + drive)
        if split:
            carry, dA = carries[:, k], torch.zeros((Bsz, E, N))
        for t in reversed(range(t0, t1)):
            dt_t, x_t, g_t = dt[:, t], x[:, t], g[:, t]
            dh = g_t[..., None] * Cm[:, t, None, :] + carry
            decay = torch.exp(dt_t[..., None] * A[None])
            dprod = (dh * hs[t - t0]) * decay
            dA = dA + dprod * dt_t[..., None]
            dbx = torch.sum(dh * Bm[:, t, None, :], dim=-1)
            ddt[:, t] = torch.sum(dprod * A[None], dim=-1) + x_t * dbx
            dx[:, t] = dt_t * dbx
            dB[:, t] = torch.sum(dh * (dt_t * x_t)[..., None], dim=1)
            dC[:, t] = torch.sum(g_t[..., None] * hs[t - t0 + 1], dim=1)
            carry = decay * dh
        if split or k == 0:
            dA_part[:, k if split else 0] = dA
    flat = dA_part.reshape(-1, E, N)
    total = flat[0]
    for i in range(1, flat.shape[0]):
        total = total + flat[i]
    return ddt, dB, dC, dx, total


@pytest.mark.parametrize("B,L,E,N", BWD_CASES)
def test_carry_pass_gives_the_plain_backward_carries(B, L, E, N):
    """The carry pass over all of L writes, bit for bit, the carry the
    plain backward starts each chunk's reverse walk from."""
    ins, g = _bwd_inputs(B, L, E, N, seed=L + E + 2)
    tins = _t(*ins)
    chunk = sk.ckpt_chunk(N)
    _, h = selective_scan_ref(*tins, ckpt_chunk=chunk)
    *_, want = selective_scan_bwd_ref(*tins, h, torch.from_numpy(g), chunk,
                                      return_carries=True)
    got = _carry_pass(tins[0], tins[2], tins[4], torch.from_numpy(g), chunk)
    assert got.shape == want.shape == h.shape
    assert not want[:, -1].any()
    assert torch.equal(got, want)


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("B,L,E,N", BWD_CASES)
def test_chunked_backward_order_matches_plain_and_jax(B, L, E, N, split):
    """The kernels' order against the plain backward (ddt, dB, dC, dx bit
    for bit: the same dh and the same terms; dA too for the one walk over
    L, and within BWD_RTOL when L is split: another order of its sum) and
    against jax.vjp of the reference's scan (every gradient within
    BWD_RTOL)."""
    ins, g = _bwd_inputs(B, L, E, N, seed=L + E)
    tins = _t(*ins)
    chunk = sk.ckpt_chunk(N)
    _, h = selective_scan_ref(*tins, ckpt_chunk=chunk)
    got = _chunked_bwd(*tins, h, torch.from_numpy(g), chunk, split)
    plain = selective_scan_bwd_ref(*tins, h, torch.from_numpy(g), chunk)
    for a, p in zip(got[:4], plain[:4]):
        assert torch.equal(a, p)
    if split:
        assert _rel_max(got[4], plain[4]) <= BWD_RTOL
    else:
        assert torch.equal(got[4], plain[4])
    _, vjp = jax.vjp(_jref, *ins)
    for a, w in zip(got, vjp(g)):
        assert a.shape == w.shape
        assert _rel_max(a, w) <= BWD_RTOL


def test_backward_plan_splits_only_a_short_grid():
    """The one walk over L where its blocks (a batch row and 128 / lanes
    channels each) fill the card at once: on an H100 (132 SMs, two chunk
    kernel blocks each, 264 slots) falcon-mamba-7b's train shape (512
    blocks) walks, two groups a block; hymba-1.5b's (100 blocks) splits
    L, BWD_GROUPS a block."""
    slots = 132 * 2
    assert sk.WALK_GROUPS == 2
    assert sk.bwd_plan(1, 8192, 16, slots) == (False, 2)
    assert sk.bwd_plan(2, 8192, 16, slots) == (False, sk.WALK_GROUPS)
    assert sk.bwd_plan(1, 1600, 16, slots) == (True, sk.BWD_GROUPS)
    assert sk.bwd_plan(1, 16 * 263, 16, slots) == (True, sk.BWD_GROUPS)
    assert sk.bwd_plan(1, 16 * 264, 16, slots) == (False, 1)
    assert sk.bwd_plan(64, 8192, 16, slots) == (False, sk.WALK_GROUPS)
    assert sk.bwd_plan(1, 5, 3, slots) == (True, sk.BWD_GROUPS)
    # a card that holds more blocks at once splits a wider grid; one that
    # holds fewer walks it
    assert sk.bwd_plan(1, 8192, 16, 132 * 4) == (True, sk.BWD_GROUPS)
    assert sk.bwd_plan(1, 8192, 16, 132) == (False, 2)


def test_backward_scratch_shapes():
    """The backward's scratch as the source's comment lays it out: the
    carries (split only) and dA partials as the checkpoints (one dA
    partial a batch row for the one walk), the dB / dC partials one a
    block of ``groups`` x 128 / lanes channels."""
    for (B, L, E, N), split, groups, nblk in (
            ((1, 4096, 1600, 16), True, 8, 13),
            ((1, 4096, 8192, 16), False, 2, 256),
            ((2, 45, 130, 1), True, 8, 1), ((1, 9, 5, 3), False, 1, 1)):
        carry, part, dA_part = sk._bwd_scratch(B, L, E, N, split, groups,
                                               "cpu")
        chunks = -(-L // sk.ckpt_chunk(N))
        assert (carry is not None) == split
        if split:
            assert carry.shape == (B, chunks, E, N)
        assert dA_part.shape == (B, chunks if split else 1, E, N)
        assert part.shape == (2, B, L, nblk, N)
        assert sk.bwd_blocks(E, N, groups) == nblk


def test_build_names_the_kernel_source():
    src = pathlib.Path(build.__file__).parent / build.SOURCES["selective_scan"]
    assert src.name == "selective_scan.cu" and src.exists()
    text = src.read_text()
    assert re.search(r'extern "C" int selective_scan\(', text)
    assert re.search(r'extern "C" int selective_scan_bwd\(', text)
    # the backward's two kernels on their own (timing): the carry pass and
    # the chunk kernel
    assert re.search(r'extern "C" int selective_scan_bwd_carry\(', text)
    assert re.search(r'extern "C" int selective_scan_bwd_chunks\(', text)
    # the plan's blocks an SM come from the CUDA runtime, not a copied count
    assert re.search(r'extern "C" int selective_scan_bwd_occupancy\(int N, '
                     r'int\* blocks\)', text)
    assert "cudaOccupancyMaxActiveBlocksPerMultiprocessor(" in text
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
    assert "--fmad=false" in build.NVCC_FLAGS
    # the accurate expf: no fast exp, no fast-math build
    assert "expf(" in text and "__expf(" not in text
    assert not any("fast_math" in f for f in build.NVCC_FLAGS)
    assert f"kMaxState = {MAX_STATE};" in text
    assert f"constexpr int kBwdGroups = {sk.BWD_GROUPS};" in text
    assert f"constexpr int kWalkGroups = {sk.WALK_GROUPS};" in text
    # the carry pass's steps a group, cut to the chunk, divide both chunk
    # sizes and go 4 to a load
    steps = int(re.search(r"constexpr int kCarrySteps = (\d+);",
                          text).group(1))
    for chunk in (16, 32):
        assert chunk % min(steps, chunk) == 0 and min(steps, chunk) % 4 == 0
    # ckpt_chunk copies Split<N>::CHUNK; the backward's two reduction
    # kernels sum in index order, with no float atomics
    assert "CHUNK = 2048 / CPB < 32 ? 2048 / CPB : 32;" in text
    assert "atomicAdd" not in text
    # the ctypes signatures: forward seven pointers (h_ckpt may be null),
    # five ints, the stream; backward fourteen pointers (the carries'
    # scratch added), six ints (split and groups added), the stream; its
    # carry pass five pointers and four ints, its chunk kernel twelve and
    # six, and the stream
    assert len(sk._SIGNATURE) == 13 and len(sk._BWD_SIGNATURE) == 21
    assert len(sk._BWD_CARRY_SIGNATURE) == 10
    assert len(sk._BWD_CHUNKS_SIGNATURE) == 19
