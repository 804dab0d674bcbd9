"""Parity of the port's flash attention with the JAX reference: the plain
PyTorch version (which the CUDA kernel is held to on the card) against
the jitted ``flash_attention_ref`` and the Pallas kernel in interpret
mode, the (B, S, H, D) GQA entry point against the reference's CPU
route, the CUDA kernel's split-TF32 products (emulated), its
tile-skipping rule, its tiles' shared memory and the wrapper's checks.

Tolerances: 2e-5 absolute and relative in float32, the reference's own
bound for its kernel against its oracle (tests/test_kernels.py); the
dense versions differ only in the summation order of two float32
products and agree far closer (see each test).  bf16: 3e-2, the
reference's bf16 bound.  The tile-skip emulation is bit-exact.
"""
import pathlib
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_threads import torch_one_thread  # noqa: F401
from repro.kernels.flash_attention.kernel import \
    flash_attention as jflash_pallas
from repro.kernels.flash_attention.ops import \
    flash_attention_op as jflash_op
from repro.kernels.flash_attention.ref import \
    flash_attention_ref as jflash_ref
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.kernels.flash_attention.ref import (NEG_INF, attn_scale,
                                                     flash_attention_ref)

TOL = 2e-5
BF16_TOL = 3e-2

_jref = jax.jit(jflash_ref, static_argnames=("causal", "window"))


def _qkv(seed, q_shape, kv_shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(dtype)
                 for s in (q_shape, kv_shape, kv_shape))


# the reference's sweep (tests/test_kernels.py) plus D = 128, where a
# division by sqrt(D) and a multiply by its float32 reciprocal differ
SWEEP = [
    (1, 2, 128, 128, 64, True, None),
    (2, 1, 64, 64, 128, False, None),
    (1, 2, 256, 256, 64, True, 64),
    (1, 1, 128, 128, 256, True, 32),
    (1, 2, 128, 128, 128, True, None),
    (1, 2, 96, 96, 128, True, 16),
]


@pytest.mark.parametrize("B,H,S,T,D,causal,window", SWEEP)
def test_plain_matches_jitted_reference(B, H, S, T, D, causal, window):
    q, k, v = _qkv(S + D, (B, H, S, D), (B, H, T, D))
    want = np.asarray(_jref(q, k, v, causal=causal, window=window))
    got = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # measured: within 2e-6 (summation order of the two einsums)
    assert np.max(np.abs(got - want)) < 2e-6


@pytest.mark.parametrize("B,H,S,T,D,causal,window,bq,bk", [
    (1, 2, 128, 128, 64, True, None, 64, 64),
    (1, 1, 128, 128, 256, True, 32, 32, 64),
])
def test_plain_matches_pallas_interpret(B, H, S, T, D, causal, window, bq, bk):
    q, k, v = _qkv(7, (B, H, S, D), (B, H, T, D))
    want = np.asarray(jflash_pallas(q, k, v, causal=causal, window=window,
                                    bq=bq, bk=bk, interpret=True))
    got = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_scale_is_the_float32_reciprocal():
    for D in fk.HEAD_DIMS:
        want = np.float32(1.0) / np.float32(np.sqrt(D))
        assert np.float32(attn_scale(D)) == want
        assert attn_scale(D) == float(want)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None), (False, 40)])
def test_op_gqa_matches_reference_cpu_route(causal, window):
    """The (B, S, H, D) entry point with GQA (H = 8, Kv = 2) against the
    reference's ``flash_attention_op``, whose CPU route is repeat plus the
    dense oracle."""
    B, S, H, Kv, D = 2, 96, 8, 2, 64
    q, k, v = _qkv(3, (B, S, H, D), (B, S, Kv, D))
    want = np.asarray(jax.jit(lambda a, b, c: jflash_op(
        a, b, c, causal=causal, window=window))(q, k, v))
    got = flash_attention_op(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal,
                             window=window).numpy()
    assert got.shape == (B, S, H, D)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_op_bf16_gqa_matches_pallas_interpret():
    """bf16 with GQA against the Pallas kernel (interpret mode) at the
    reference's bf16 bound."""
    B, S, H, Kv, D = 2, 128, 8, 2, 64
    q, k, v = _qkv(4, (B, S, H, D), (B, S, Kv, D))
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jflash_op(jq, jk, jv, bq=64, bk=64, interpret=True)
                      .astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                  .to(torch.bfloat16) for a in (jq, jk, jv))
    got = flash_attention_op(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_TOL,
                               atol=BF16_TOL)


@pytest.mark.parametrize("S,T,causal,window", [
    (200, 333, False, None),    # ragged: no tile divides either length
    (200, 64, False, 32),       # rows past T + 31 see no key at all
    (200, 64, True, 32),
])
def test_ragged_and_keyless_rows_match_reference(S, T, causal, window):
    """Shapes the reference's Pallas kernel refuses (S % bq != 0); its
    oracle takes them.  A row that sees no key averages all T values under
    the uniform -1e30 scores, in both."""
    q, k, v = _qkv(5, (1, 2, S, 64), (1, 2, T, 64))
    want = np.asarray(_jref(q, k, v, causal=causal, window=window))
    got = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_query_offset_selects_rows():
    """``q_offset`` checks a slice of the query rows on its own (the chip
    run's check of the 32k prefill)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(6, (1, 2, 96, 64),
                                                 (1, 2, 96, 64)))
    full = flash_attention_ref(q, k, v, causal=True)
    part = flash_attention_ref(q[:, :, 64:], k, v, causal=True, q_offset=64)
    torch.testing.assert_close(part, full[:, :, 64:], rtol=0, atol=1e-6)


# --------------------------------------------------------------------------
# the CUDA kernel's split-TF32 products, emulated
# --------------------------------------------------------------------------

def _tf32(x, ties):
    """float32 -> TF32 (10 mantissa bits), to nearest: ties away from
    zero, as the kernel rounds (half a TF32 ulp added to the bits, as
    cvt.rna.tf32.f32), or to even."""
    u = x.view(torch.int32).long()
    if ties == "away":
        u = u + 0x1000
    else:
        u = u + 0xFFF + ((u >> 13) & 1)
    return (u & ~0x1FFF).to(torch.int32).view(torch.float32)


def _mm(a, b, passes, ties):
    """a @ b on TF32 operands, float32 accumulation: one pass, or the
    kernel's three (small.big + big.small + big.big of x = big + small)."""
    ab, bb = _tf32(a, ties), _tf32(b, ties)
    if passes == 1:
        return ab @ bb
    as_, bs = _tf32(a - ab, ties), _tf32(b - bb, ties)
    return as_ @ bb + ab @ bs + ab @ bb


def _tf32_attention(q, k, v, causal, window, passes, ties):
    """(B, H, S, D) attention with the kernel's products: S = Q K^T and
    O = P V in TF32 passes, the softmax in float32."""
    S, D, T = q.shape[2], q.shape[3], k.shape[2]
    s = _mm(q, k.transpose(-1, -2), passes, ties) * attn_scale(D)
    qi, kj = torch.arange(S)[:, None], torch.arange(T)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= qi - kj < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.max(dim=-1, keepdim=True).values)
    return _mm(p, v, passes, ties) / p.sum(dim=-1, keepdim=True)


@pytest.mark.parametrize("H,S,D,causal,window", [
    (2, 128, 64, True, None),
    (2, 96, 64, True, 24),
    (1, 128, 128, True, None),
    (1, 80, 128, False, 32),
])
def test_split_tf32_holds_the_float32_tolerance(H, S, D, causal, window):
    """Three TF32 passes (the kernel's products) stay within TOL of the
    jitted float32 reference, with either rounding of the split; one pass
    (plain TF32) misses it."""
    q, k, v = _qkv(S + D + 1, (1, H, S, D), (1, H, S, D))
    want = np.asarray(_jref(q, k, v, causal=causal, window=window))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for ties in ("away", "even"):
        got = _tf32_attention(tq, tk, tv, causal, window, 3, ties).numpy()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        # measured: within 2e-6, as close as two float32 orders of summation
        assert np.max(np.abs(got - want)) < 2e-6
    one = _tf32_attention(tq, tk, tv, causal, window, 1, "even").numpy()
    assert np.max(np.abs(one - want)) > 10 * TOL


def test_tf32_rounding_emulation():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11),
                      1 + 2 ** -11 + 2 ** -20], dtype=torch.float32)
    # ties at 1 + 2^-11 (half of 2^-10): away rounds up, even rounds down;
    # 1 + 3 * 2^-11 ties to the even 1 + 2^-9 both ways
    assert _tf32(x, "away").tolist() == [1.0, 1 + 2 ** -10, 1 + 2 ** -9,
                                         -(1 + 2 ** -10), 1 + 2 ** -10]
    assert _tf32(x, "even").tolist() == [1.0, 1.0, 1 + 2 ** -9, -1.0,
                                         1 + 2 ** -10]
    big = _tf32(x, "away")
    assert torch.equal(big + _tf32(x - big, "away"), x)


# --------------------------------------------------------------------------
# the CUDA kernel's tile skipping, emulated tile by tile in float32
# --------------------------------------------------------------------------

def _kv_tiles(q0, bq, S, T, bk, causal, window, skip):
    """The KV tiles flash_attention.cu visits for the query tile at q0
    (its tiles are fk.TILES[D]; smaller ones test the rule more
    finely)."""
    q_last = min(q0 + bq, S) - 1
    begin, end = 0, -(-T // bk)
    if skip and (window is None or q_last - (T - 1) < window):
        if causal:
            end = min(end, q_last // bk + 1)
        if window is not None:
            begin = max(0, q0 - window + 1) // bk
    return range(begin, end)


def _streamed(q, k, v, causal, window, bq, bk, skip):
    """The reference kernel's update, one (query tile, KV tile) at a time,
    visiting the tiles the CUDA kernel visits (skip) or all of them."""
    S, D = q.shape
    T = k.shape[0]
    scale = attn_scale(D)
    out = torch.empty_like(q)
    for q0 in range(0, S, bq):
        qt = q[q0:q0 + bq]
        rows = torch.arange(q0, q0 + qt.shape[0])[:, None]
        m = torch.full((qt.shape[0], 1), NEG_INF)
        l = torch.zeros((qt.shape[0], 1))
        acc = torch.zeros((qt.shape[0], D))
        for kt in _kv_tiles(q0, bq, S, T, bk, causal, window, skip):
            keys = torch.arange(kt * bk, min(kt * bk + bk, T))[None, :]
            s = (qt @ k[keys[0]].T) * scale
            mask = torch.ones_like(s, dtype=torch.bool)
            if causal:
                mask &= keys <= rows
            if window is not None:
                mask &= rows - keys < window
            s = torch.where(mask, s, NEG_INF)
            m_cur = torch.maximum(m, s.max(dim=1, keepdim=True).values)
            alpha = torch.exp(m - m_cur)
            p = torch.exp(s - m_cur)
            l = l * alpha + p.sum(dim=1, keepdim=True)
            acc = acc * alpha + p @ v[keys[0]]
            m = m_cur
        out[q0:q0 + bq] = acc / torch.clamp(l, min=1e-30)
    return out


@pytest.mark.parametrize("S,T,causal,window", [
    (256, 256, True, None),     # above the diagonal
    (256, 256, True, 32),       # query tiles 2-3 start past the window
    (256, 256, False, 48),      # window without causality: both sides
    (192, 100, True, 24),       # rows that see no key: every tile walked
])
def test_tile_skipping_changes_no_value(S, T, causal, window):
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, (S, 64), (T, 64)))
    for bq, bk in (fk.TILES[64], fk.TILES[128], (32, 32)):
        skipped = _streamed(q, k, v, causal, window, bq, bk, skip=True)
        walked = _streamed(q, k, v, causal, window, bq, bk, skip=False)
        assert torch.equal(skipped, walked)
        if window is not None and S <= T:
            assert len(_kv_tiles(S - bq, bq, S, T, bk, causal, window,
                                 True)) < -(-T // bk)
    want = flash_attention_ref(q[None, None], k[None, None], v[None, None],
                               causal=causal, window=window)[0, 0]
    torch.testing.assert_close(skipped, want, rtol=TOL, atol=TOL)


# --------------------------------------------------------------------------
# tiles, checks, gradients
# --------------------------------------------------------------------------

_CU = pathlib.Path(fk.__file__).parent / "csrc" / "flash_attention.cu"


@pytest.mark.parametrize("D", fk.HEAD_DIMS)
def test_one_tile_fits_shared_memory_at_every_head_dim(D):
    """The kernel's tiles at head dim D (fk.TILES, Tile<T, D> in the
    source): Q staged once in float32 (rows padded by 4), two stages of K
    and V raw (rows padded by 16 bytes).  Every (D, dtype) fits the 227 KB
    of dynamic shared memory of a Hopper block, and D = 64 leaves room for
    two blocks an SM; the source holds both in static_asserts."""
    src = _CU.read_text()
    bq, bk = fk.TILES[D]
    assert "constexpr int kWarps64 = 4;" in src
    assert "constexpr int kMTiles64 = 2;" in src
    assert "constexpr int MT = D == 64 ? kMTiles64 : 1;" in src
    assert "constexpr int BK = D == 64 ? 64 : 32;" in src
    assert bq == 4 * 16 * (2 if D == 64 else 1) and bk == (64 if D == 64
                                                           else 32)
    assert "static_assert(Tile<float, 256>::kSmem <= kSmemPerBlock" in src
    assert "static_assert(Tile<float, 64>::kSmem <= kSmemPerBlock / 2" in src
    for esize in (4, 2):
        smem = bq * (D + 4) * 4 + 2 * 2 * bk * (D + 16 // esize) * esize
        assert smem <= 227 * 1024
        if D == 64:
            assert smem <= 227 * 1024 // 2
    if D == 256:
        assert bq * (D + 4) * 4 + 4 * bk * (D + 4) * 4 == 199_680
    # the route: TF32 MMAs from operands rounded half away (_tf32's
    # "away"), the profiler's kernel name
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "return __float_as_uint(x) + 0x1000u;" in src
    assert "tf32_operand(x) & 0xFFFFE000u" in src and "cp.async" in src
    assert re.search(r"__global__ void __launch_bounds__\(Tile<T, D>::"
                     r"kThreads\)\s+flash_fwd\(", src)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "mixed", "gqa",
                                 "window"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.zeros(1, 8, 4, 64), torch.zeros(1, 8, 2, 64),
               torch.zeros(1, 8, 2, 64))
    kwargs = {}
    if bad == "head_dim":
        q, k, v = q[..., :32], k[..., :32], v[..., :32]
    elif bad == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif bad == "mixed":
        k = k.to(torch.bfloat16)
    elif bad == "gqa":
        k, v = torch.zeros(1, 8, 3, 64), torch.zeros(1, 8, 3, 64)
    else:
        kwargs["window"] = 0
    with pytest.raises(ValueError):
        fk.flash_attention(q, k, v, **kwargs)


def test_kernel_layout_check():
    """The CUDA route's layout rule (checked before any launch)."""
    x = torch.zeros(2, 8, 4, 64)
    fk._check_layout(x, "q")
    fk._check_layout(torch.zeros(2, 8, 12 * 64)[..., 64:320]
                     .reshape(2, 8, 4, 64), "q")   # a qkv_fused view
    with pytest.raises(ValueError):
        fk._check_layout(x.transpose(1, 3), "q")
    with pytest.raises(ValueError):
        fk._check_layout(torch.zeros(2 * 8 * 4 * 64 + 1)[1:]
                         .reshape(2, 8, 4, 64), "q")
    # bf16: 16-byte copies need strides in multiples of 8 elements
    fk._check_layout(torch.zeros(2, 8, 12 * 64, dtype=torch.bfloat16)
                     [..., 64:320].reshape(2, 8, 4, 64), "q")
    with pytest.raises(ValueError):   # a row stride of 260 elements
        fk._check_layout(torch.zeros(2, 8, 260, dtype=torch.bfloat16)
                         [..., :256].reshape(2, 8, 4, 64), "q")


def test_other_devices_raise():
    q = torch.zeros(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError):
        fk.flash_attention(q, q, q)


def test_cuda_op_has_no_gradient():
    with pytest.raises(NotImplementedError, match="dense"):
        fk._FlashAttention.backward(None, torch.zeros(1))


def test_cpu_route_gradient_matches_reference():
    """The CPU route keeps autograd, as the reference's does: gradients of
    a weighted sum of the output with respect to q, k, v (GQA, causal)."""
    B, S, H, Kv, D = 1, 64, 4, 2, 64
    q, k, v = _qkv(9, (B, S, H, D), (B, S, Kv, D))
    w = np.random.default_rng(10).normal(size=(B, S, H, D)).astype(np.float32)
    want = jax.jit(jax.grad(lambda a, b, c: jnp.sum(jflash_op(a, b, c) * w),
                            argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (flash_attention_op(tq, tk, tv) * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)
