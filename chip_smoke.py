#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, then runs
these phases and fails (non-zero exit, no result line) on any error:

  kernels  every kernel against its plain PyTorch version on the card, at
           the small shapes of the CPU tests (QSGD: zero buckets, ragged
           tails, levels 1/7/127, 1/3/8 clients, with and without weights;
           natural: ±0, subnormals, ±Inf, NaN, the exponent-254 carry,
           1/3/8 clients, with and without weights, all bit-exact);
  paper    compressed L2GD on the quickstart's logistic regression
           (5 clients, d = 124, 500 steps), held against the port's own
           CPU run with the same key: QSGD (packed uplink, flat downlink)
           and natural (auto plans: flat uplink, flat downlink);
  leafwise the same configuration (100 steps) with each of the seven
           compressors of the paper pinned to the leafwise transport both
           ways, GPU against CPU: qsgd and natural launch their
           explicit-noise kernel twice a fresh round, the other five
           nothing;
  width    the trainer on the parameter tree of stablelm-1.6b at full
           width and 4 of its 24 layers (d = 411,060,224 per client,
           8 clients, a quadratic objective), once with the flat and once
           with the packed downlink, for QSGD and then for natural, each
           codec's launch counters reset before and read after; then each
           kernel on that run's final buffer: checked on its first and
           last 4096 buckets against the plain version and timed against
           its bound;
  flash    the flash-attention kernel against its plain version on the
           card at the small shapes of the CPU tests (causal and not,
           windows 32 / 64, D = 64 / 128 / 256, ragged S = 200 / T = 333,
           rows that see no key, GQA H = 8 / Kv = 2, every tile, f32 and
           bf16, a strided qkv view), and a backward through it raises;
  prefill  stablelm-1.6b at full width and depth (24 layers, f32, random
           weights from a seeded generator) on B = 2 sequences of 4096
           tokens of the token stream: build_prefill_step and forward with
           attn_impl="flash" (24 kernel launches each), then forward with
           dense attention, logits held against each other;
  serve    two requests: 64 prompt tokens teacher-forced through
           build_serve_step into the KV caches, then 16 greedy tokens;
           decode logits held against forward's, the greedy tokens
           against forward's argmax on the extended sequences;
  flash width  the kernel at the prefill shapes against the bound of its
           route (three split-TF32 passes on the tensor cores) and the
           CUDA-core float32 bound, its plain version and
           scaled_dot_product_attention; then once at the prefill_32k
           length, checked on the last 256 query rows of two heads;
  selective_scan  the scan kernel against its plain version on the card
           at the CPU tests' shapes and hymba's E = 1600 (ragged L and E,
           N = 4 / 8 / 16, f32 and bf16), its state checkpoints against
           the plain trajectory, and a bfloat16 backward raises;
  selective_scan backward  the backward kernels against the plain
           backward on the same operands at those shapes and hymba's
           E = 1600 with ragged L and E: each gradient within 2e-5 x max
           |plain|, two launches bit-identical, the autograd op on the
           card giving the kernel's gradients, and the carry pass alone
           within 2e-5 x max |plain| of the plain backward's carries;
  mamba    falcon-mamba-7b (64 Mamba layers) and then hymba-1.5b (32
           hybrid layers: sliding-window dense attention beside Mamba) at
           full width and depth, f32, random weights from a seeded
           generator, one after the other: build_prefill_step on B = 2
           sequences of 4096 tokens (one scan launch per layer), a
           torch.profiler breakdown, forward with the last layer's scan
           held against the plain version on its own inputs; then the
           serve phase above through the Mamba (and ring KV) caches,
           which runs no kernel;
  scan width  the kernel at both prefill shapes (E = 8192 and 1600)
           against its bound and its plain version, with its warps in
           flight;
  dequantize  the two explicit-noise kernels of the leafwise codecs
           (qsgd_dequantized, natural_compress_2d) against their plain
           versions on the card and on the CPU at the CPU tests' shapes
           (levels 1/7/127/255, zero buckets, ±0, subnormals, ±Inf, NaN,
           carries; float32 and bfloat16);
  train    stablelm-1.6b at full width and depth (24 layers, f32, remat
           on, dense attention, random weights from seeded generators),
           2 clients x one 4096-token sequence of the token stream:
           build_train_step with leafwise natural, then leafwise QSGD,
           both ways, forced xi [0, 1, 1, 0, 1]: exactly 44 launches of
           the codec's kernel (2 fresh rounds x 11 leaves x 2 links) and
           no other, finite losses, peak memory <= 70 GB, the bits
           ledger; torch.profiler breakdowns of one local and one fresh
           aggregation step;
  train width  each codec's kernel on that run's largest leaf (2 x
           276,824,064 elements) against its plain version and its
           bound, and the threefry draw that feeds it;
  train (Mamba)  hymba-1.5b at full width and depth (32 hybrid layers,
           leafwise natural) and falcon-mamba-7b at full width and 8 of
           its 64 layers (leafwise QSGD), as the train phase: the scan
           forward 2 clients x layers x (5 steps + 2 local recomputes),
           its backward 2 clients x layers x 2 local steps, the codec 2 x
           leaves x 2; profiles with the scan's shares;
  scan backward width  the backward kernel at both train shapes (B = 1,
           L = 4096, E = 1600 / 8192) against the plain backward, twice
           bit for bit, timed against its bound, the plain backward and
           the plain route (autograd through the chunked scan, one
           layer), its carry pass and chunk kernel each timed alone and
           the carries held against the plain backward's; the forward
           timed with and without checkpoints;
  model grad  a 2-layer hymba-1.5b at full width on 512 tokens: the
           card's loss and gradient (the scan kernels) against the CPU's
           (the chunked scan under autograd) from the same params, each
           leaf within 1e-4 x its max.

The last two lines of standard output are one JSON object describing
the kernels and one JSON object naming the device.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, NVIDIA data sheet
PEAK_F32_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
PEAK_TF32_OPS_PER_S = 495e12   # H100 SXM TF32 tensor cores, dense
FLASH_PASSES = 3               # split-TF32 passes of each f32 product
# int32 instructions: 64 INT32 lanes per SM and clock (half the FP32
# lanes, Hopper white paper) x 132 SMs x 1.98 GHz boost
PEAK_I32_OPS_PER_S = 132 * 64 * 1.98e9
NORM_ULPS = 4                  # bucket-norm bound of tests/test_torch_qsgd.py
WINDOW = 4096                  # buckets per window the plain version checks
CUDA_SOURCE = "src/repro_torch/kernels/qsgd/csrc/qsgd.cu"
REPLACES = {
    "qsgd_pack": "src/repro/kernels/qsgd/kernel.py:187",
    "qsgd_reduce": "src/repro/kernels/qsgd/ops.py:78",
    "qsgd_fused": "src/repro/kernels/qsgd/kernel.py:132",
    "qsgd_unpack": "src/repro/kernels/qsgd/kernel.py:238",
}
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:71"
FLASH_TOL = 2e-5               # f32 bound of tests/test_kernels.py:124
PREFILL_B, PREFILL_S = 2, 4096  # the train_4k sequence length
LONG_S = 32768                 # the prefill_32k sequence length
LONG_ROWS = 256                # query rows checked at 32k (two heads)
LOGIT_RTOL = 1e-5              # flash vs dense logits, x max |logit|
DECODE_TOL = 2e-4              # tests/test_models_smoke.py:112
PROMPT, GENERATE = 64, 16
NATURAL_SOURCE = "src/repro_torch/kernels/natural/csrc/natural.cu"
NATURAL_REPLACES = {
    "natural_pack": "src/repro/kernels/natural/kernel.py:129",
    "natural_reduce": "src/repro/kernels/natural/ops.py:86",
    "natural_fused": "src/repro/kernels/natural/kernel.py:88",
}
LEAFWISE = ("identity", "natural", "qsgd", "terngrad", "bernoulli", "randk",
            "topk")
PAPER_LOSS_RTOL = 1e-3         # the paper phases' GPU-vs-CPU loss bound
LEAFWISE_STEPS = 100           # per codec and device in the leafwise phase
# the kernel each leafwise codec runs (the others run none)
LEAFWISE_KERNELS = {"qsgd": "qsgd_dequantized",
                    "natural": "natural_compress_2d"}
DEQUANT_REPLACES = {
    "qsgd_dequantized": "src/repro/kernels/qsgd/kernel.py:94",
    "natural_compress_2d": "src/repro/kernels/natural/kernel.py:51",
}
DEQUANT_SOURCES = {"qsgd_dequantized": CUDA_SOURCE,
                   "natural_compress_2d": NATURAL_SOURCE}
# phase train: stablelm-1.6b at full width and depth, 2 clients, one
# sequence of the train_4k length each (its batch of 256 cut to 1 a
# client), the forced xi trace of the width phases
TRAIN_CLIENTS, TRAIN_B, TRAIN_S = 2, 1, 4096
TRAIN_XI = [0, 1, 1, 0, 1]
TRAIN_PEAK = 70e9              # the memory limit of PERF.md section 2
STABLELM_PARAMS = 1_438_746_624
STABLELM_LEAVES = 11
# stablelm-1.6b (repro/configs/stablelm_1_6b.py) at full width, 4 layers:
# the leaf shapes of repro/models/model.py::init_params
D_MODEL, D_FF, VOCAB, LAYERS = 2048, 5632, 100352, 4
WIDTH_D = 411_060_224
WIDTH_CLIENTS = 8
SCAN_SOURCE = "src/repro_torch/kernels/selective_scan/csrc/selective_scan.cu"
SCAN_REPLACES = "src/repro/kernels/selective_scan/kernel.py:60"
# the kernel and its plain version round every product and sum alike and
# call the same expf, so the state agrees; y differs in the order of the
# N-term sum: bound 16 float32 ulps of max |y|
SCAN_ULPS = 16
SCAN_CASES = [   # B, L, E, N: tests/test_kernels.py's sweep, hymba's E
    (1, 16, 8, 4), (2, 64, 32, 16), (1, 100, 48, 16), (3, 33, 16, 8),
    (2, 37, 24, 8), (1, 257, 1600, 16),
]
# the exp of every state update runs on the special-function units: 16
# results per SM and clock for compute capability 9.0 (CUDA C++
# programming guide, arithmetic instruction throughput) x 132 SMs x
# 1.98 GHz boost
PEAK_SFU_OPS_PER_S = 132 * 16 * 1.98e9
MAMBA_PARAMS = {"falcon-mamba-7b": 7_006_326_784,
                "hymba-1.5b": 1_352_246_400}
# the scan's backward: each gradient within GRAD_RTOL of
# tests/test_torch_train.py, x max |plain|, at the forward's small shapes
# and hymba's width with ragged L and E
SCAN_BWD_RTOL = 2e-5
SCAN_BWD_CASES = SCAN_CASES + [(2, 129, 1605, 16)]
SCAN_GRADS = ("ddt", "dB", "dC", "dx", "dA")
# the reference's gradient of the scan is XLA's autodiff of this function
SCAN_BWD_REPLACES = "src/repro/models/mamba.py:75"
# float32 operations of one state update in the backward: the state
# recomputed (dt*A, dx*B, decay*h, + drive), the reverse step (g*C,
# + carry, dh*h, *decay, *dt, + dA, *A, + sum, dh*B, + sum, dh*dx, g*h,
# decay*dh) and the sums over E of dB's and dC's terms
SCAN_BWD_OPS = 19
# phases train (Mamba): hymba-1.5b at full width and depth; falcon-mamba-7b
# at full width and 8 of its 64 layers (two clients' f32 params, cache and
# gradients at 64 layers exceed the card's 80 GB)
MAMBA_TRAIN = (("hymba-1.5b", None, "natural"),
               ("falcon-mamba-7b", 8, "qsgd"))
TRAIN_PARAMS = {("stablelm-1.6b", None): STABLELM_PARAMS,
                ("hymba-1.5b", None): 1_352_246_400,
                ("falcon-mamba-7b", 8): 1_108_840_448}
# phase model grad: 2-layer hymba-1.5b at full width, one sequence of 512
# tokens, the card's gradient (the scan kernels) against the CPU's (the
# chunked scan under autograd) from the same params: max |d| over max
# |cpu| of each leaf.  The bound is a choice, set before the first run:
# the two sum the matrix products (K up to 5504) in other orders and the
# scans round differently (2.4e-7 of y, tests/test_torch_mamba.py), and
# the reduced models' gradients hold 2e-5 against jax.grad on the CPU
MODEL_GRAD_LAYERS, MODEL_GRAD_S = 2, 512
MODEL_GRAD_RTOL = 1e-4


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def ulps(a, b):
    import torch
    a, b = a.float(), b.float()
    spacing = torch.abs(torch.nextafter(a, torch.full_like(a, np.inf)) - a)
    return float(torch.max(torch.abs(a - b) / spacing.clamp_min(1e-45)))


# --------------------------------------------------------------------------
# phase kernels: small shapes
# --------------------------------------------------------------------------

def phase_kernels_small(dev):
    import torch
    from repro_torch.kernels.qsgd import ref
    from repro_torch.kernels.qsgd.kernel import (qsgd_fused, qsgd_pack,
                                                 qsgd_unpack)
    from repro_torch.kernels.qsgd.ops import qsgd_reduce
    rng = np.random.default_rng(0)
    shapes = {"zero-bucket": (4, 128), "ragged-tail": (3, 2048),
              "lanes": (2, 384), "odd-bucket": (3, 100)}
    worst = 0.0
    for kind, (nb, b) in shapes.items():
        x = rng.normal(size=(3, nb, b)).astype(np.float32)
        if kind == "zero-bucket":
            x[:, 1] = 0.0
        if kind == "ragged-tail":
            x.reshape(3, -1)[:, 5000:] = 0.0
        seeds = rng.integers(0, 2 ** 32, size=(3, 2), dtype=np.uint64) \
            .astype(np.uint32)
        xd = torch.from_numpy(x).to(dev)
        for levels in (1, 7, 127):
            codes, norms = qsgd_pack(xd, seeds, levels=levels)
            for i in range(3):
                given, _ = ref.qsgd_pack_ref(xd[i], seeds[i], levels=levels,
                                             norms=norms[i])
                check(torch.equal(codes[i], given),
                      f"pack codes {kind} levels {levels} client {i}")
                _, plain_norms = ref.qsgd_pack_ref(xd[i], seeds[i],
                                                   levels=levels)
                worst = max(worst, ulps(plain_norms, norms[i]))
            fused = qsgd_fused(xd[0].contiguous(), seeds[0], levels=levels)
            check(torch.equal(fused, ref.qsgd_fused_ref(
                xd[0], seeds[0], levels=levels, norms=norms[0])),
                f"fused {kind} levels {levels}")
            unpacked = qsgd_unpack(codes[0].contiguous(),
                                   norms[0].contiguous(), levels=levels)
            check(torch.equal(unpacked, ref.qsgd_unpack_ref(
                codes[0], norms[0], levels=levels)), f"unpack {kind}")
            check(torch.equal(unpacked, fused), f"unpack != fused {kind}")
    check(worst <= NORM_ULPS, f"bucket norms {worst} ulps from the plain sum")
    for n in (1, 3, 8):
        codes = torch.from_numpy(rng.integers(-7, 8, size=(n, 6, 128))
                                 .astype(np.int8)).to(dev)
        norms = torch.from_numpy(rng.uniform(0.1, 5, size=(n, 6, 1))
                                 .astype(np.float32)).to(dev)
        for w in (None, torch.from_numpy(rng.uniform(0, 2, size=n)
                                         .astype(np.float32)).to(dev)):
            check(torch.equal(qsgd_reduce(codes, norms, w, levels=7),
                              ref.qsgd_reduce_ref(codes, norms, w, levels=7)),
                  f"reduce n={n} weights={w is not None}")
    torch.cuda.synchronize()
    log(f"phase kernels: small shapes ok (bucket norms within {worst:g} ulps "
        "of the plain sum; codes, fused, unpack, reduce bit-exact)")
    return worst


def bits_equal(a, b):
    """Bit-for-bit equality of two float32 tensors (NaN, -0.0 included)."""
    import torch
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def bits_equal_but_nan(a, b):
    """Bit-for-bit equality except that a NaN equals any NaN: a NaN made
    by arithmetic (Inf - Inf) is 0x7FFFFFFF on the card and 0xFFC00000 on
    an x86 CPU."""
    import torch
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and bits_equal(a[~nan], b[~nan])


def natural_buffer(rng, n, nb, b):
    """(n, nb, b) float32 with a zero bucket, ±0, subnormals, ±Inf, NaN and
    the largest finite values (whose bump carries to ±Inf)."""
    x = rng.normal(size=(n, nb, b)).astype(np.float32)
    x[:, 1] = 0.0
    bits = x.reshape(n, -1).view(np.uint32)
    bits[:, :7] = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40,
                            -1e-42], np.float32).view(np.uint32)
    bits[:, 8:16] = 0x7F7FFFFF
    bits[:, 16:24] = 0xFF7FFFFF
    bits[:, 24:56] = rng.integers(1, 0x7FFFFF, size=(n, 32)).astype(np.uint32)
    bits[:, 40:56] |= 0x80000000
    return x


def phase_natural_kernels_small(dev):
    import torch
    from repro_torch.core import flatbuf
    from repro_torch.core.codec import NaturalPayload
    from repro_torch.kernels.bits import natural_merge, unpack_bits
    from repro_torch.kernels.natural import ref
    from repro_torch.kernels.natural.kernel import natural_fused, natural_pack
    from repro_torch.kernels.natural.ops import natural_reduce
    rng = np.random.default_rng(1)
    for nb, b in ((6, 128), (3, 2048), (5, 384), (7, 8)):
        x = natural_buffer(rng, 3, nb, b)
        seeds = rng.integers(0, 2 ** 32, size=(3, 2), dtype=np.uint64) \
            .astype(np.uint32)
        xd = torch.from_numpy(x).to(dev)
        exps, signs = natural_pack(xd, seeds)
        for i in range(3):
            e, sg = ref.natural_pack_ref(xd[i], seeds[i])
            check(torch.equal(exps[i], e) and torch.equal(signs[i], sg),
                  f"natural pack ({nb}, {b}) client {i}")
        fused = natural_fused(xd[0].contiguous(), seeds[0])
        check(bits_equal(fused, ref.natural_fused_ref(xd[0], seeds[0])),
              f"natural fused ({nb}, {b})")
        check(bits_equal(fused.cpu(), ref.natural_fused_ref(
            torch.from_numpy(x[0]), seeds[0])), f"natural fused vs CPU {b}")
        # the merge (plain PyTorch on both sides) on the card's payload
        merged = natural_merge(exps, unpack_bits(signs, 1))
        check(bits_equal(merged.cpu(), natural_merge(
            exps.cpu(), unpack_bits(signs.cpu(), 1))), "natural_merge")
        kept = ~torch.isnan(fused)     # NaN leaves the 9-bit wire as Inf
        check(bits_equal(merged[0][kept], fused[kept]),
              "merge(pack) != fused")
        layout = flatbuf.layout_of({"w": torch.zeros(nb * b)}, b)
        tree = flatbuf.unpack_tree(NaturalPayload(exps, signs, layout=layout))
        cpu_tree = flatbuf.unpack_tree(NaturalPayload(
            exps.cpu(), signs.cpu(), layout=layout))
        check(bits_equal(tree["w"].cpu(), cpu_tree["w"]), "unpack_tree")
    sign = natural_merge(torch.zeros(1, dtype=torch.uint8, device=dev),
                         torch.ones(1, dtype=torch.uint8, device=dev))
    check(int(sign.view(torch.int32).item()) & 0xFFFFFFFF == 0x80000000,
          "(sign << 31) is not 0x80000000 on the card")
    # (6, 128) takes the 16-element group kernel, (3, 8) the float4 one
    for n, (nb, b) in ((n, s) for n in (1, 3, 8) for s in ((6, 128), (3, 8))):
        exps = torch.from_numpy(rng.integers(0, 256, size=(n, nb, b))
                                .astype(np.uint8)).to(dev)
        signs = torch.from_numpy(rng.integers(0, 256, size=(n, nb, b // 8))
                                 .astype(np.uint8)).to(dev)
        for w in (None, torch.from_numpy(rng.uniform(0, 2, size=n)
                                         .astype(np.float32)).to(dev)):
            got = natural_reduce(exps, signs, w)
            check(bits_equal(got, ref.natural_reduce_ref(exps, signs, w)),
                  f"natural reduce n={n} b={b} weights={w is not None}")
            check(bits_equal_but_nan(got.cpu(), ref.natural_reduce_ref(
                exps.cpu(), signs.cpu(), None if w is None else w.cpu())),
                f"natural reduce vs CPU n={n}")
    torch.cuda.synchronize()
    log("phase kernels: natural pack, fused, reduce bit-exact against their "
        "plain versions on the card and on the CPU (±0, subnormals, ±Inf, "
        "NaN, carries; 1/3/8 clients), merge and unpack_tree too")


# --------------------------------------------------------------------------
# phase paper: the quickstart configuration, GPU against the port on CPU
# --------------------------------------------------------------------------

def phase_paper(dev):
    import torch
    from repro_torch.core import L2GDHyper, make_compressor, make_plan, prng
    from repro_torch.data import logreg_loss_and_grad, make_logreg_data
    from repro_torch.fl import run_l2gd
    from repro_torch.kernels.dispatch import LAUNCHES, reset_launches

    n, steps = 5, 500
    data = make_logreg_data(n_clients=n, heterogeneity=1.5, seed=0)

    def grad_fn(p, b):
        loss, g = logreg_loss_and_grad(p["w"], b[0], b[1], 0.01)
        return loss, {"w": g}

    def run_on(device):
        X = torch.from_numpy(data.features).to(device)
        Y = torch.from_numpy(data.labels).to(device)
        comp = make_compressor("qsgd")
        plan = make_plan(comp, {"w": torch.zeros(124)}, transport="packed")
        t0 = time.perf_counter()
        run = run_l2gd(prng.PRNGKey(0), {"w": torch.zeros(n, 124)}, grad_fn,
                       L2GDHyper(eta=0.5, lam=1.0, p=0.3, n=n),
                       lambda k: (X, Y), steps, client_comp=comp,
                       master_comp=comp, plan=plan, device=device)
        w = run.state.params["w"]
        final = float(torch.mean(grad_fn({"w": w}, (X, Y))[0]))
        if device != "cpu":
            torch.cuda.synchronize()
        return run, final, time.perf_counter() - t0

    reset_launches()
    gpu, gpu_loss, gpu_s = run_on(dev)
    launches = dict(LAUNCHES)
    cpu, cpu_loss, _ = run_on("cpu")
    check(np.array_equal(gpu.xis, cpu.xis), "xi traces differ")
    check(gpu.ledger == cpu.ledger, "ledgers differ")
    check((gpu.n_local, gpu.n_agg_comm, gpu.n_agg_cached)
          == (cpu.n_local, cpu.n_agg_comm, cpu.n_agg_cached),
          "branch counts differ")
    for name in ("qsgd_pack", "qsgd_reduce", "qsgd_fused"):
        check(launches.get(name, 0) > 0, f"{name} never launched")
    # the QSGD-run tolerances of tests/test_torch_l2gd.py: params within
    # one downlink level, losses within 1e-3 relative
    w_gpu = gpu.state.params["w"].cpu().numpy()
    w_cpu = cpu.state.params["w"].numpy()
    level = np.sqrt(np.sum(np.mean(w_cpu, 0) ** 2)) / 127
    check(np.max(np.abs(w_gpu - w_cpu)) <= level, "params beyond one level")
    check(abs(gpu_loss - cpu_loss) <= 1e-3 * abs(cpu_loss),
          f"final loss {gpu_loss} vs CPU {cpu_loss}")
    check(gpu_loss < gpu.losses[0][1], "the loss did not fall")
    log(f"phase paper: final mean local loss {gpu_loss:.6f} (CPU "
        f"{cpu_loss:.6f}, start {gpu.losses[0][1]:.6f}); bits/n "
        f"{gpu.ledger.bits_per_client:.6e}; rounds {gpu.ledger.rounds}; "
        f"max |w_gpu - w_cpu| {np.max(np.abs(w_gpu - w_cpu)):.3e}; "
        f"{steps} steps in {gpu_s:.2f} s; launches {launches}")


def paper_run(device, comp, plan, steps=500):
    """The quickstart's configuration on ``device``: (run, final mean local
    loss, seconds)."""
    import torch
    from repro_torch.core import L2GDHyper, prng
    from repro_torch.data import logreg_loss_and_grad, make_logreg_data
    from repro_torch.fl import run_l2gd

    n = 5
    data = make_logreg_data(n_clients=n, heterogeneity=1.5, seed=0)
    X = torch.from_numpy(data.features).to(device)
    Y = torch.from_numpy(data.labels).to(device)

    def grad_fn(p, b):
        loss, g = logreg_loss_and_grad(p["w"], b[0], b[1], 0.01)
        return loss, {"w": g}

    t0 = time.perf_counter()
    run = run_l2gd(prng.PRNGKey(0), {"w": torch.zeros(n, 124)}, grad_fn,
                   L2GDHyper(eta=0.5, lam=1.0, p=0.3, n=n),
                   lambda k: (X, Y), steps, client_comp=comp,
                   master_comp=comp, plan=plan, device=device)
    final = float(torch.mean(grad_fn(run.state.params, (X, Y))[0]))
    if device != "cpu":
        torch.cuda.synchronize()
    return run, final, time.perf_counter() - t0


def same_protocol(gpu, cpu, what):
    check(np.array_equal(gpu.xis, cpu.xis), f"{what}: xi traces differ")
    check(gpu.ledger == cpu.ledger, f"{what}: ledgers differ")
    check((gpu.n_local, gpu.n_agg_comm, gpu.n_agg_cached)
          == (cpu.n_local, cpu.n_agg_comm, cpu.n_agg_cached),
          f"{what}: branch counts differ")


def phase_paper_natural(dev):
    """The quickstart's natural line: auto plans, so the uplink is the
    flat engine (pack + reduce) and the downlink the fused kernel."""
    from repro_torch.core import make_compressor
    from repro_torch.kernels.dispatch import LAUNCHES, reset_launches

    comp = make_compressor("natural")
    reset_launches()
    gpu, gpu_loss, gpu_s = paper_run(dev, comp, None)
    launches = dict(LAUNCHES)
    cpu, cpu_loss, _ = paper_run("cpu", comp, None)
    same_protocol(gpu, cpu, "natural paper")
    for name in NATURAL_REPLACES:
        check(launches.get(name, 0) > 0, f"{name} never launched (paper)")
    # natural runs: GPU and CPU logistic gradients differ in the last
    # bits, which can move a value across a rounding boundary of the next
    # compression: losses within PAPER_LOSS_RTOL
    w_gpu = gpu.state.params["w"].cpu().numpy()
    w_cpu = cpu.state.params["w"].numpy()
    check(abs(gpu_loss - cpu_loss) <= PAPER_LOSS_RTOL * abs(cpu_loss),
          f"natural final loss {gpu_loss} vs CPU {cpu_loss}")
    check(gpu_loss < gpu.losses[0][1], "natural: the loss did not fall")
    log(f"phase paper (natural): final mean local loss {gpu_loss:.6f} (CPU "
        f"{cpu_loss:.6f}, start {gpu.losses[0][1]:.6f}); bits/n "
        f"{gpu.ledger.bits_per_client:.6e}; rounds {gpu.ledger.rounds}; "
        f"max |w_gpu - w_cpu| {np.max(np.abs(w_gpu - w_cpu)):.3e}; "
        f"500 steps in {gpu_s:.2f} s; launches {launches}")


def phase_leafwise(dev):
    """Every compressor of the paper, leafwise both ways, GPU against CPU.
    Leafwise QSGD and natural run the explicit-noise kernels (one launch
    per leaf and link of a fresh round); the other five codecs are plain
    PyTorch (the reference has no kernel for them) and launch nothing."""
    import torch
    from repro_torch.core import make_compressor, make_plan
    from repro_torch.kernels.dispatch import LAUNCHES, reset_launches

    one = {"w": torch.zeros(124)}
    summary = []
    t0 = time.perf_counter()
    for name in LEAFWISE:
        comp = make_compressor(name)
        plans = (make_plan(comp, one, transport="leafwise"),
                 make_plan(comp, one, transport="leafwise"))
        reset_launches()
        gpu, gpu_loss, _ = paper_run(dev, comp, plans, LEAFWISE_STEPS)
        launches = dict(LAUNCHES)
        cpu, cpu_loss, _ = paper_run("cpu", comp, plans, LEAFWISE_STEPS)
        same_protocol(gpu, cpu, f"leafwise {name}")
        # one leaf, two links: two launches a fresh round
        want = {} if name not in LEAFWISE_KERNELS else \
            {LEAFWISE_KERNELS[name]: 2 * gpu.n_agg_comm}
        check(launches == want, f"leafwise {name} launched {launches}")
        if np.isfinite(cpu_loss):
            check(abs(gpu_loss - cpu_loss) <= PAPER_LOSS_RTOL * abs(cpu_loss),
                  f"leafwise {name}: final loss {gpu_loss} vs CPU {cpu_loss}")
        summary.append(f"{name} {gpu_loss:.6f}/{cpu_loss:.6f} "
                       f"({gpu.ledger.bits_per_client:.4e} bits/n)")
    log(f"phase leafwise: 7 codecs x {LEAFWISE_STEPS} steps on GPU and CPU in "
        f"{time.perf_counter() - t0:.1f} s; xi traces, ledgers, branch "
        f"counts equal; final loss GPU/CPU: " + "; ".join(summary))


# --------------------------------------------------------------------------
# phase width: the trainer at stablelm-1.6b width
# --------------------------------------------------------------------------

def width_tree(n, make):
    """The stacked parameter tree, every leaf from ``make(shape)``."""
    L, D, F = LAYERS, D_MODEL, D_FF
    return {
        "embed": {"table": make((n, VOCAB, D))},
        "final_norm": {"scale": make((n, D))},
        "layers": {
            "attn": {k: make((n, L, D, D)) for k in ("wq", "wk", "wv", "wo")},
            "ffn": {"w_gate": make((n, L, D, F)), "w_up": make((n, L, D, F)),
                    "w_down": make((n, L, F, D))},
            "ln1": {"scale": make((n, L, D))},
            "ln2": {"scale": make((n, L, D))},
        },
    }


def width_objective(dev, n):
    """(seeded leaf maker, targets tree, grad_fn) of the width phases:
    f_i(w) = 0.5 ||w - a_i||^2 over every leaf (the quadratic fixture of
    tests/conftest.py), targets a_i ~ N(0, 1) from seed 1."""
    import torch
    from repro_torch.core.tree import tree_map
    gen = torch.Generator(device=dev)

    def seeded(seed, scale):
        gen.manual_seed(seed)
        return lambda shape: torch.randn(shape, generator=gen, device=dev) \
            .mul_(scale)

    targets = width_tree(n, seeded(1, 1.0))

    def grad_fn(params, batch):
        # the norm avoids a squared temporary
        losses = torch.zeros(n, device=dev)

        def one(w, a):
            g = w - a
            losses.add_(torch.linalg.vector_norm(g.reshape(n, -1), dim=1)
                        .square_().mul_(0.5))
            return g

        return losses, tree_map(one, params, batch)

    return seeded, targets, grad_fn


def phase_width(dev):
    import torch
    from repro_torch.core import L2GDHyper, make_compressor, make_plan, prng
    from repro_torch.core import flatbuf
    from repro_torch.core.tree import tree_leaves
    from repro_torch.fl import run_l2gd
    from repro_torch.kernels.dispatch import LAUNCHES, reset_launches

    n = WIDTH_CLIENTS
    seeded, targets, grad_fn = width_objective(dev, n)
    comp = make_compressor("qsgd")
    one_client = width_tree(1, lambda s: torch.empty(s[1:], device="meta"))
    up = make_plan(comp, one_client, transport="packed")
    check(up.round_bits() == 8 * WIDTH_D + 32 * (WIDTH_D // 2048),
          "uplink message bits")
    reset_launches()        # the main path starts here
    for down_transport in ("flat", "packed"):
        down = make_plan(comp, one_client, transport=down_transport)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        run = run_l2gd(prng.PRNGKey(0), width_tree(n, seeded(0, 0.02)),
                       grad_fn, L2GDHyper(eta=0.5, lam=1.0, p=0.3, n=n),
                       lambda k: targets, 5, plan=(up, down),
                       xi_trace=[0, 1, 1, 0, 1], device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        check(list(run.xis) == [0, 1, 1, 0, 1], "forced xi trace")
        check((run.n_local, run.n_agg_comm, run.n_agg_cached) == (2, 2, 1),
              "branch counts")
        check(run.ledger.rounds == 2 and run.ledger.uplink_bits_per_client
              == 2 * 3_294_904_608, "ledger uplink bits")
        for leaf in tree_leaves(run.state.params):
            check(bool(torch.isfinite(leaf).all()), "non-finite params")
        log(f"phase width ({down_transport} downlink): {n} clients x "
            f"d={WIDTH_D}; {seconds / 5 * 1e3:.1f} ms per step (5 steps, "
            f"first-call costs included); peak allocated "
            f"{peak / 1e9:.2f} GB; losses "
            f"{[round(v, 1) for _, v in run.losses]}")
        if down_transport == "packed":
            layout = flatbuf.layout_of(run.state.params, 2048, batch_dims=1)
            buf = flatbuf.ravel(layout, run.state.params)
        del run
    launches = dict(LAUNCHES)   # the main path ends here
    for name in REPLACES:
        check(launches.get(name, 0) > 0, f"{name} never launched at width")
    del targets
    torch.cuda.empty_cache()
    log(f"phase width: launches {launches}")
    return flatbuf.bucketize(buf, 2048).contiguous(), launches


# --------------------------------------------------------------------------
# kernels at the width shapes: windows against the plain version, timing
# --------------------------------------------------------------------------

def time_ms(fn, reps, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def time_ms_queued(fn, reps, warmup=2):
    """Device ms a call: CUDA events around ``reps`` calls queued back to
    back, so that the host's work for a call overlaps the device's for
    the one before (time_ms's events around each call also take in the
    wrapper's Python, a tenth of a millisecond or so)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_width_kernels(x, launches, norm_ulps):
    import torch
    from repro_torch.kernels.qsgd import ref
    from repro_torch.kernels.qsgd.kernel import (qsgd_fused, qsgd_pack,
                                                 qsgd_unpack)
    from repro_torch.kernels.qsgd.ops import qsgd_reduce

    n, nb, b = x.shape
    d = nb * b
    levels = 127
    seeds = np.stack([np.arange(n, dtype=np.uint32) * 2 + 1,
                      np.arange(n, dtype=np.uint32) * 2 + 2], axis=1)
    weights = torch.ones(n, device=x.device)
    codes, norms = qsgd_pack(x, seeds, levels=levels)
    fused = qsgd_fused(x[0], seeds[0], levels=levels)
    unpacked = qsgd_unpack(codes[0], norms[0], levels=levels)
    reduced = qsgd_reduce(codes, norms, weights, levels=levels)
    torch.cuda.synchronize()
    err = {k: 0.0 for k in REPLACES}
    for r0 in (0, nb - WINDOW):
        win = slice(r0, r0 + WINDOW)
        for i in (0, n - 1):
            given, plain_norms = ref.qsgd_pack_ref(
                x[i, win], seeds[i], levels=levels, row_offset=r0,
                norms=norms[i, win])
            check(torch.equal(codes[i, win], given),
                  f"pack codes, window at {r0}, client {i}")
            _, plain_norms = ref.qsgd_pack_ref(x[i, win], seeds[i],
                                               levels=levels, row_offset=r0)
            norm_ulps = max(norm_ulps, ulps(plain_norms, norms[i, win]))
            err["qsgd_pack"] = max(err["qsgd_pack"], float(
                torch.max(torch.abs(plain_norms - norms[i, win]))))
        check(torch.equal(fused[win], ref.qsgd_fused_ref(
            x[0, win], seeds[0], levels=levels, row_offset=r0,
            norms=norms[0, win])), f"fused, window at {r0}")
        own = ref.qsgd_fused_ref(x[0, win], seeds[0], levels=levels,
                                 row_offset=r0)
        level = norms[0, win] / levels
        check(bool(torch.all(torch.abs(own - fused[win]) <= level * 1.000001)),
              "fused beyond one level of its plain version")
        err["qsgd_fused"] = max(err["qsgd_fused"],
                                float(torch.max(torch.abs(own - fused[win]))))
        check(torch.equal(unpacked[win], ref.qsgd_unpack_ref(
            codes[0, win], norms[0, win], levels=levels)), "unpack window")
        check(torch.equal(reduced[win], ref.qsgd_reduce_ref(
            codes[:, win], norms[:, win], weights, levels=levels)),
            "reduce window")
    check(norm_ulps <= NORM_ULPS, f"bucket norms {norm_ulps} ulps off")
    log(f"phase width kernels: windows at rows 0 and {nb - WINDOW} ok "
        f"(codes/fused/unpack/reduce bit-exact given the kernel's norms; "
        f"norms within {norm_ulps:g} ulps)")

    nbytes = {
        "qsgd_pack": n * d * 4 + n * d + n * nb * 4,
        "qsgd_reduce": n * d + n * nb * 4 + n * 4 + d * 4,
        "qsgd_fused": d * 4 + d * 4,
        "qsgd_unpack": d + nb * 4 + d * 4,
    }
    # float32 operations per element: pack/fused square+add (norm), abs,
    # div, mul, floor, sub, compare, add, sign (+ the dequantize multiply
    # in fused); unpack one multiply; reduce two multiplies and an add per
    # client
    nops = {"qsgd_pack": 10 * n * d, "qsgd_fused": 11 * d,
            "qsgd_unpack": d, "qsgd_reduce": 3 * n * d}
    kernel_fns = {
        "qsgd_pack": lambda: qsgd_pack(x, seeds, levels=levels),
        "qsgd_reduce": lambda: qsgd_reduce(codes, norms, weights,
                                           levels=levels),
        "qsgd_fused": lambda: qsgd_fused(x[0], seeds[0], levels=levels),
        "qsgd_unpack": lambda: qsgd_unpack(codes[0], norms[0], levels=levels),
    }
    plain_fns = {
        "qsgd_pack": lambda: [ref.qsgd_pack_ref(x[i], seeds[i], levels=levels)
                              for i in range(n)],
        "qsgd_reduce": lambda: ref.qsgd_reduce_ref(codes, norms, weights,
                                                   levels=levels),
        "qsgd_fused": lambda: ref.qsgd_fused_ref(x[0], seeds[0],
                                                 levels=levels),
        "qsgd_unpack": lambda: ref.qsgd_unpack_ref(codes[0], norms[0],
                                                   levels=levels),
    }
    rows = []
    for name in REPLACES:
        ms = time_ms(kernel_fns[name], reps=25)
        plain_ms = time_ms(plain_fns[name], reps=3, warmup=1)
        bytes_ms = nbytes[name] / PEAK_BYTES_PER_S * 1e3
        ops_ms = nops[name] / PEAK_F32_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": CUDA_SOURCE,
            "replaces": REPLACES[name], "launches": launches.get(name, 0),
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
        })
        log(f"time {name}: {ms:.3f} ms (bound {max(bytes_ms, ops_ms):.3f} ms"
            f", {nbytes[name] / 1e9:.3f} GB; {bytes_ms / ms:.0%} of the "
            f"memory roofline); plain version {plain_ms:.1f} ms")
    return rows


def phase_width_natural(dev):
    """The width trainer with natural compression: packed uplink (pack +
    reduce), flat then packed downlink (fused, then pack + merge)."""
    import torch
    from repro_torch.core import L2GDHyper, make_compressor, make_plan, prng
    from repro_torch.core import flatbuf
    from repro_torch.core.tree import tree_leaves
    from repro_torch.fl import run_l2gd
    from repro_torch.kernels.dispatch import LAUNCHES, reset_launches

    n = WIDTH_CLIENTS
    seeded, targets, grad_fn = width_objective(dev, n)
    comp = make_compressor("natural")
    one_client = width_tree(1, lambda s: torch.empty(s[1:], device="meta"))
    up = make_plan(comp, one_client, transport="packed")
    check(up.round_bits() == 9 * WIDTH_D == 3_699_542_016,
          "natural uplink message bits")
    steps_ms, peaks = {}, {}
    reset_launches()        # the natural main path starts here
    for down_transport in ("flat", "packed"):
        down = make_plan(comp, one_client, transport=down_transport)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        run = run_l2gd(prng.PRNGKey(0), width_tree(n, seeded(0, 0.02)),
                       grad_fn, L2GDHyper(eta=0.5, lam=1.0, p=0.3, n=n),
                       lambda k: targets, 5, plan=(up, down),
                       xi_trace=[0, 1, 1, 0, 1], device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peaks[down_transport] = torch.cuda.max_memory_allocated(dev)
        steps_ms[down_transport] = seconds / 5 * 1e3
        check(list(run.xis) == [0, 1, 1, 0, 1], "forced xi trace")
        check((run.n_local, run.n_agg_comm, run.n_agg_cached) == (2, 2, 1),
              "branch counts")
        check(run.ledger.rounds == 2 and run.ledger.uplink_bits_per_client
              == 2 * 3_699_542_016, "natural ledger uplink bits")
        for leaf in tree_leaves(run.state.params):
            check(bool(torch.isfinite(leaf).all()), "non-finite params")
        log(f"phase width natural ({down_transport} downlink): {n} clients "
            f"x d={WIDTH_D}; {steps_ms[down_transport]:.1f} ms per step (5 "
            f"steps, first-call costs included); peak allocated "
            f"{peaks[down_transport] / 1e9:.2f} GB; losses "
            f"{[round(v, 1) for _, v in run.losses]}")
        if down_transport == "packed":
            layout = flatbuf.layout_of(run.state.params, 128, batch_dims=1)
            buf = flatbuf.ravel(layout, run.state.params)
        del run
    launches = dict(LAUNCHES)   # the natural main path ends here
    for name in NATURAL_REPLACES:
        check(launches.get(name, 0) > 0, f"{name} never launched at width")
    del targets
    torch.cuda.empty_cache()
    log(f"phase width natural: launches {launches}")
    return flatbuf.bucketize(buf, 128).contiguous(), launches


def phase_width_kernels_natural(x, launches):
    import torch
    from repro_torch.kernels.natural import ref
    from repro_torch.kernels.natural.kernel import natural_fused, natural_pack
    from repro_torch.kernels.natural.ops import natural_reduce

    n, nb, b = x.shape
    d = nb * b
    seeds = np.stack([np.arange(n, dtype=np.uint32) * 2 + 1,
                      np.arange(n, dtype=np.uint32) * 2 + 2], axis=1)
    weights = torch.ones(n, device=x.device)
    exps, signs = natural_pack(x, seeds)
    fused = natural_fused(x[0], seeds[0])
    reduced = natural_reduce(exps, signs, weights)
    torch.cuda.synchronize()
    for r0 in (0, nb - WINDOW):
        win = slice(r0, r0 + WINDOW)
        for i in (0, n - 1):
            e, sg = ref.natural_pack_ref(x[i, win], seeds[i], row_offset=r0)
            check(torch.equal(exps[i, win], e) and torch.equal(signs[i, win],
                                                               sg),
                  f"natural pack, window at {r0}, client {i}")
        check(bits_equal(fused[win], ref.natural_fused_ref(
            x[0, win], seeds[0], row_offset=r0)),
            f"natural fused, window at {r0}")
        check(bits_equal(reduced[win], ref.natural_reduce_ref(
            exps[:, win], signs[:, win], weights)),
            f"natural reduce, window at {r0}")
    log(f"phase width kernels natural: windows at rows 0 and {nb - WINDOW} "
        "bit-exact (pack codes and signs, fused, reduce)")

    nbytes = {
        "natural_pack": n * d * 4 + n * d + n * d // 8,
        "natural_reduce": n * d + n * d // 8 + n * 4 + d * 4,
        "natural_fused": d * 4 + d * 4,
    }
    # int32 operations per element: the counter hash (index multiply-add,
    # xor, fmix32: 3 shifts, 3 xors, 2 multiplies) 11, the rounding (mask,
    # shift, compare, exponent test, select, and, add) 8, and pack's code
    # and sign extraction 4; the reduce's merge (2 shifts, or, mask) 4 and
    # one float multiply and add per client
    nops = {"natural_pack": 23 * n * d, "natural_fused": 19 * d,
            "natural_reduce": 6 * n * d}
    kernel_fns = {
        "natural_pack": lambda: natural_pack(x, seeds),
        "natural_reduce": lambda: natural_reduce(exps, signs, weights),
        "natural_fused": lambda: natural_fused(x[0], seeds[0]),
    }
    plain_fns = {
        "natural_pack": lambda: [ref.natural_pack_ref(x[i], seeds[i])
                                 for i in range(n)],
        "natural_reduce": lambda: ref.natural_reduce_ref(exps, signs,
                                                         weights),
        "natural_fused": lambda: ref.natural_fused_ref(x[0], seeds[0]),
    }
    rows = []
    for name in NATURAL_REPLACES:
        ms = time_ms(kernel_fns[name], reps=25)
        # one call: the plain pack takes about a second at this size
        plain_ms = time_ms(plain_fns[name], reps=1, warmup=0)
        bytes_ms = nbytes[name] / PEAK_BYTES_PER_S * 1e3
        ops_ms = nops[name] / PEAK_I32_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": NATURAL_SOURCE,
            "replaces": NATURAL_REPLACES[name],
            "launches": launches.get(name, 0), "max_abs_err": 0.0,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
        })
        log(f"time {name}: {ms:.3f} ms (bound {max(bytes_ms, ops_ms):.3f} ms"
            f", {nbytes[name] / 1e9:.3f} GB = {bytes_ms:.3f} ms, "
            f"{nops[name] / 1e9:.1f} G int32 ops = {ops_ms:.3f} ms; "
            f"{max(bytes_ms, ops_ms) / ms:.0%} of the roofline); plain "
            f"version {plain_ms:.1f} ms")
    return rows


# --------------------------------------------------------------------------
# phase flash: the flash-attention kernel at the CPU tests' shapes
# --------------------------------------------------------------------------

def bf16_ulps(got, want, floor=FLASH_TOL):
    """|got - want| in units of the bf16 spacing at the larger of the two
    magnitudes (8 significand bits), floored at ``floor``, the float32
    bound: both versions round one float32 value, and near zero (an
    output that cancels) the float32 values' own difference, bounded by
    ``floor``, exceeds the bf16 spacing.  Returns (worst units, |want|
    there)."""
    import torch
    got, want = got.float(), want.float()
    _, exp = torch.frexp(torch.maximum(got.abs(), want.abs()))
    ulp = torch.ldexp(torch.ones_like(got), exp - 8)
    units = (torch.abs(got - want) / torch.clamp(ulp, min=floor)) \
        .reshape(-1)
    at = int(torch.argmax(units))
    return float(units[at]), float(want.reshape(-1)[at].abs())


FLASH_CASES = [   # B, S, T, H, Kv, D, causal, window
    (1, 128, 128, 2, 2, 64, True, None),
    (2, 64, 64, 1, 1, 128, False, None),
    (1, 256, 256, 2, 2, 64, True, 64),      # query tiles start past it
    (1, 128, 128, 1, 1, 256, True, 32),
    (1, 128, 128, 2, 2, 128, True, None),
    (1, 200, 333, 2, 2, 64, False, None),   # ragged S and T
    (1, 200, 64, 2, 2, 64, False, 32),      # rows that see no key
    (1, 200, 64, 2, 2, 64, True, 32),
    (2, 128, 128, 8, 2, 64, True, None),    # GQA
    (2, 96, 96, 8, 2, 256, False, 40),
]


def phase_flash_small(dev):
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk
    gen = torch.Generator(device=dev)
    worst, worst_ulps, n = 0.0, 0.0, 0
    for B, S, T, H, Kv, D, causal, window in FLASH_CASES:
        gen.manual_seed(S * 1000 + D)
        q = torch.randn((B, S, H, D), generator=gen, device=dev)
        k = torch.randn((B, T, Kv, D), generator=gen, device=dev)
        v = torch.randn((B, T, Kv, D), generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
            plain = fk._plain(qd, kd, vd, causal, window)
            got = fk.flash_attention(qd, kd, vd, causal=causal,
                                     window=window)
            torch.cuda.synchronize()
            what = (f"flash B{B} S{S} T{T} H{H}/{Kv} D{D} causal "
                    f"{causal} window {window} {dtype}")
            check(got.dtype == dtype and got.shape == q.shape, what)
            if dtype == torch.float32:
                err = float(torch.max(torch.abs(got - plain)))
                check(err <= FLASH_TOL, f"{what}: max |d| {err:.3g}")
                worst = max(worst, err)
            else:
                u, at = bf16_ulps(got, plain)
                check(u <= 1.0, f"{what}: {u:.2f} bf16 ulps at |y| "
                      f"{at:.3g}")
                worst_ulps = max(worst_ulps, u)
            n += 1
    # the qkv_fused layout hands the kernel strided views of one product
    qkv = torch.randn((2, 96, 12 * 64), generator=gen, device=dev)
    q, k, v = (qkv[..., i * 256:(i + 1) * 256].reshape(2, 96, 4, 64)
               for i in range(3))
    err = float(torch.max(torch.abs(fk.flash_attention(q, k, v)
                                    - fk._plain(q, k, v, True, None))))
    check(err <= FLASH_TOL, f"flash on strided views: {err:.3g}")
    q = q.contiguous().requires_grad_()
    try:
        fk.flash_attention(q, k, v).sum().backward()
    except NotImplementedError:
        pass
    else:
        raise AssertionError("a backward through the CUDA op did not raise")
    log(f"phase flash: {n} kernel calls against the plain version on the "
        f"card (f32 max |d| {worst:.3g} <= {FLASH_TOL:g}; bf16 within "
        f"{worst_ulps:.2f} ulp, or {FLASH_TOL:g} where the ulp is finer); "
        "strided views ok; backward raises")


# --------------------------------------------------------------------------
# phases prefill and serve: stablelm-1.6b at full width and depth
# --------------------------------------------------------------------------

def timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def device_profile(fn):
    """Run ``fn`` once under torch.profiler: (wall ms, {"flash" |
    "selective_scan" | "gemm" | "other": device ms}, kernel count).  The
    device ms are the kernels' own times (one stream, so they do not
    overlap); wall ms minus their sum is the card's idle time.  Empty when
    the profiler sees no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kind = {"flash": 0.0, "selective_scan": 0.0, "gemm": 0.0, "other": 0.0}
    count = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        name = e.key.lower()
        kind = "flash" if "flash_fwd" in name else \
            "selective_scan" if "scan_kernel<" in name else \
            "gemm" if "gemm" in name or "gemv" in name else "other"
        by_kind[kind] += us / 1e3
        count += e.count
    return wall_ms, by_kind, count


def profile_line(what, wall_ms, by_kind, count):
    busy = sum(by_kind.values())
    if not count:
        return f"profile {what}: the profiler saw no device activity"
    return (f"profile {what}: wall {wall_ms:.2f} ms, {count} kernels, device "
            f"busy {busy:.2f} ms (idle share {1 - busy / wall_ms:.1%}): " +
            ", ".join(f"{k} {v:.2f} ms" for k, v in by_kind.items() if v))


def top2_gap(logits):
    import torch
    top = torch.topk(logits, 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def phase_prefill(dev):
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.kernels.dispatch import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import forward, init_params, param_count

    cfg = dataclasses.replace(get_config("stablelm-1.6b"), attn_impl="flash")
    params, init_s = timed(lambda: init_params(
        torch.Generator(device=dev).manual_seed(0), cfg))
    check(param_count(params) == 1_438_746_624, "stablelm parameter count")
    tokens = torch.from_numpy(TokenStream(
        n_clients=1, vocab=cfg.vocab_size, batch=PREFILL_B,
        seq=PREFILL_S).batch_at(0)[0]).long().to(dev)
    batch = {"tokens": tokens}
    prefill = build_prefill_step(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()            # the prefill main path starts here
    last, first_s = timed(lambda: prefill(params, batch))
    launches = dict(LAUNCHES)   # and ends here
    check(launches == {"flash_attention": cfg.n_layers},
          f"prefill step launches {launches}")
    check(last.shape == (PREFILL_B, cfg.vocab_size)
          and bool(torch.isfinite(last).all()), "prefill logits")
    _, prefill_s = timed(lambda: prefill(params, batch))
    log(profile_line("prefill step", *device_profile(
        lambda: prefill(params, batch))))
    # forward keeps the last layer's attention operands: the kernel is
    # held to its plain version on the model's own activations
    op, seen = flash_ops.flash_attention_op, []

    def keep_last(q, k, v, **kw):
        out = op(q, k, v, **kw)
        seen[:] = [(q, k, v, kw, out)]
        return out

    flash_ops.flash_attention_op = keep_last
    reset_launches()
    try:
        with torch.no_grad():
            flash, flash_s = timed(lambda: forward(params, cfg, batch)[0])
    finally:
        flash_ops.flash_attention_op = op
    check(LAUNCHES["flash_attention"] == cfg.n_layers,
          f"forward launches {dict(LAUNCHES)}")
    flash_peak = torch.cuda.max_memory_allocated(dev)
    q, k, v, kw, out = seen.pop()
    plain = fk._plain(q, k, v, kw["causal"], kw["window"])
    layer_err = float(torch.max(torch.abs(out - plain)))
    layer_bound = FLASH_TOL * max(1.0, float(plain.abs().max()))
    check(layer_err <= layer_bound, f"layer {cfg.n_layers - 1} flash vs "
          f"plain on its own q, k, v: {layer_err:.3g} > {layer_bound:.3g}")
    del q, k, v, out, plain
    # the step unembeds one position (a matrix-vector product), forward
    # all of them: equal up to the products' summation order
    step_err = float(torch.max(torch.abs(flash[:, -1] - last)))
    check(step_err <= 1e-5 * float(last.abs().max()),
          f"prefill step vs forward's last position: {step_err:.3g}")
    dense_cfg = dataclasses.replace(cfg, attn_impl="dense")
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    with torch.no_grad():
        dense, dense_s = timed(lambda: forward(params, dense_cfg, batch)[0])
    check(not LAUNCHES, f"dense forward launched {dict(LAUNCHES)}")
    dense_peak = torch.cuda.max_memory_allocated(dev)
    scale = float(dense.abs().max())
    err = float(torch.max(torch.abs(flash - dense)))
    bound = LOGIT_RTOL * scale
    check(bool(torch.isfinite(flash).all()), "non-finite flash logits")
    check(err <= bound, f"flash vs dense logits: {err:.3g} > {bound:.3g}")
    clear = top2_gap(dense) > bound
    same = torch.argmax(flash, -1) == torch.argmax(dense, -1)
    check(bool(same[clear].all()), "argmax differs where the gap is clear")
    del dense
    log(f"phase prefill: stablelm-1.6b, {cfg.n_layers} layers, "
        f"{param_count(params):,} params (init {init_s:.2f} s); B={PREFILL_B}"
        f" S={PREFILL_S}: prefill step {first_s:.3f} s first, "
        f"{prefill_s:.3f} s second; forward flash {flash_s:.3f} s (peak "
        f"{flash_peak / 1e9:.2f} GB), dense {dense_s:.3f} s (peak "
        f"{dense_peak / 1e9:.2f} GB); logits flash vs dense max |d| "
        f"{err:.3g} = {err / scale:.3g} x max |logit| {scale:.3f} (bound "
        f"{LOGIT_RTOL:g} x); layer {cfg.n_layers - 1} kernel vs plain on "
        f"its own activations max |d| {layer_err:.3g} (<= {layer_bound:.3g})"
        f"; step vs forward max |d| {step_err:.3g}; argmax "
        f"equal at {int(clear.sum())} of {clear.numel()} positions with a "
        f"clear top-2 gap ({float(same.float().mean()):.4f} of all); "
        f"launches {launches}")
    return cfg, params, tokens, launches


def phase_serve(dev, cfg, params, tokens):
    import torch
    from repro_torch.kernels.dispatch import LAUNCHES, reset_launches
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models import forward, init_caches

    prompt = tokens[:, :PROMPT]
    serve = build_serve_step(cfg)
    caches = init_caches(cfg, PREFILL_B, PROMPT + GENERATE, device=dev)
    reset_launches()            # the serve main path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prompt_logits = []
    for i in range(PROMPT):
        logits, caches = serve(params, caches, i,
                               {"tokens": prompt[:, i:i + 1]})
        prompt_logits.append(logits)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    generated = [torch.argmax(prompt_logits[-1], -1)]
    gen_logits = []
    for i in range(PROMPT, PROMPT + GENERATE - 1):
        logits, caches = serve(params, caches, i,
                               {"tokens": generated[-1][:, None]})
        gen_logits.append(logits)
        generated.append(torch.argmax(logits, -1))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(not LAUNCHES, f"{cfg.name} decode launched {dict(LAUNCHES)}")
    log(profile_line(f"{cfg.name} decode step", *device_profile(lambda: serve(
        params, caches, PROMPT + GENERATE - 1,
        {"tokens": generated[-1][:, None]}))))
    generated = torch.stack(generated, 1)
    with torch.no_grad():
        full, _ = forward(params, cfg, {"tokens": torch.cat(
            [prompt, generated[:, :-1]], 1)})
    decoded = torch.stack(prompt_logits + gen_logits, 1)
    err = float(torch.max(torch.abs(decoded - full)))
    check(err <= DECODE_TOL, f"{cfg.name} decode vs forward logits {err:.3g}")
    # each greedy token is forward's argmax where the top-2 gap is clear
    fwd = full[:, PROMPT - 1:]
    clear = top2_gap(fwd) > 2 * DECODE_TOL
    check(bool((torch.argmax(fwd, -1) == generated)[clear].all()),
          f"{cfg.name}: greedy tokens differ from forward's argmax")
    log(f"phase serve ({cfg.name}): {PREFILL_B} requests x {PROMPT} prompt "
        f"tokens "
        f"({(t1 - t0) / PROMPT * 1e3:.2f} ms per teacher-forced step) + "
        f"{GENERATE} greedy tokens ({(t2 - t1) / (GENERATE - 1) * 1e3:.2f} ms "
        f"per decode step); decode vs forward logits max |d| {err:.3g} "
        f"(<= {DECODE_TOL:g}; at the prompt positions "
        f"{float(torch.max(torch.abs(decoded - full)[:, :PROMPT])):.3g}); "
        f"tokens {generated[0, :8].tolist()}...")


# --------------------------------------------------------------------------
# flash at the prefill shapes and at 32k: time, bound, plain, library
# --------------------------------------------------------------------------

def flash_bound_ms(B, H, S, D):
    """Causal (S = T), f32 inputs: (pairs, route ms, CUDA-core ms, bytes
    ms).  The kernel's route: 3 split-TF32 passes of 4 D flops per visible
    pair on the tensor cores, or one exp a pair on the special-function
    units if that is larger.  Beside it the CUDA-core float32 bound (4 D
    flops a pair at 67 TFLOP/s), which only a design on the CUDA cores is
    held to; and q, k, v and the output read / written once."""
    pairs = B * H * S * (S + 1) // 2
    tf32_ms = FLASH_PASSES * 4 * D * pairs / PEAK_TF32_OPS_PER_S * 1e3
    exp_ms = pairs / PEAK_SFU_OPS_PER_S * 1e3
    f32_ms = 4 * D * pairs / PEAK_F32_OPS_PER_S * 1e3
    bytes_ms = 4 * B * S * H * D * 4 / PEAK_BYTES_PER_S * 1e3
    return pairs, max(tf32_ms, exp_ms), f32_ms, bytes_ms


def phase_flash_width(dev, launches):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    B, S, H, D = PREFILL_B, PREFILL_S, 32, 64
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn((B, S, H, D), generator=gen, device=dev)
               for _ in range(3))
    out = flash_attention_op(q, k, v)
    plain = fk._plain(q, k, v, True, None)
    err = float(torch.max(torch.abs(out - plain)))
    check(err <= FLASH_TOL, f"flash at the prefill shapes: {err:.3g}")
    del plain
    ms = time_ms(lambda: flash_attention_op(q, k, v), reps=10)
    plain_ms = time_ms(lambda: fk._plain(q, k, v, True, None), reps=3,
                       warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib_err = float(torch.max(torch.abs(lib.transpose(1, 2) - out)))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), reps=10)
    pairs, ops_ms, f32_ms, bytes_ms = flash_bound_ms(B, H, S, D)
    log(f"time flash_attention (B={B} S=T={S} H={H} D={D} causal f32): "
        f"{ms:.3f} ms (route bound {ops_ms:.3f} ms: {pairs:,} pairs, "
        f"{FLASH_PASSES} x {4 * D * pairs / 1e9:.1f} GFLOP of TF32 or "
        f"{pairs:.3g} exps; bytes {bytes_ms:.3f} ms; {ops_ms / ms:.0%} of "
        f"it; CUDA-core f32 bound {f32_ms:.3f} ms, the kernel at "
        f"{ms / f32_ms:.2f}x it); plain version {plain_ms:.1f} ms; "
        f"scaled_dot_product_attention {library_ms:.3f} ms (the kernel at "
        f"{ms / library_ms:.2f}x it; max |d| {lib_err:.3g} from the "
        f"kernel); kernel vs plain max |d| {err:.3g}")
    row = {"name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
           "replaces": FLASH_REPLACES,
           "launches": launches.get("flash_attention", 0),
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "library_ms": library_ms}
    del q, k, v, qt, kt, vt, out, lib
    torch.cuda.empty_cache()

    # prefill_32k: one sequence of 32768 tokens
    q, k, v = (torch.randn((1, LONG_S, H, D), generator=gen, device=dev)
               for _ in range(3))
    out = flash_attention_op(q, k, v)
    long_ms = time_ms(lambda: flash_attention_op(q, k, v), reps=3, warmup=0)
    rows = slice(LONG_S - LONG_ROWS, LONG_S)
    long_err = 0.0
    for h in (0, H - 1):
        want = flash_attention_ref(
            q[:, rows, h:h + 1].transpose(1, 2), k[:, :, h:h + 1]
            .transpose(1, 2), v[:, :, h:h + 1].transpose(1, 2), causal=True,
            q_offset=LONG_S - LONG_ROWS).transpose(1, 2)
        long_err = max(long_err, float(torch.max(torch.abs(
            out[:, rows, h:h + 1] - want))))
    check(long_err <= FLASH_TOL, f"flash at 32k: {long_err:.3g}")
    check(bool(torch.isfinite(out).all()), "non-finite flash output at 32k")
    pairs, ops_ms, f32_ms, _ = flash_bound_ms(1, H, LONG_S, D)
    log(f"time flash_attention (B=1 S=T={LONG_S} H={H} D={D} causal f32): "
        f"{long_ms:.2f} ms (route bound {ops_ms:.2f} ms: {pairs:,} pairs; "
        f"{ops_ms / long_ms:.0%} of it; CUDA-core f32 bound {f32_ms:.2f} ms,"
        f" the kernel at {long_ms / f32_ms:.2f}x it); last {LONG_ROWS} query"
        f" rows of heads 0 and {H - 1} vs the plain version max |d| "
        f"{long_err:.3g}")
    del q, k, v, out
    torch.cuda.empty_cache()
    return row


# --------------------------------------------------------------------------
# phase selective_scan: the scan kernel at the CPU tests' shapes
# --------------------------------------------------------------------------

def scan_inputs(gen, B, L, E, N, dev):
    """Drawn as tests/test_kernels.py draws them: dt = softplus(normal) *
    0.2, B, C and x normal, A = -|normal|."""
    import torch
    import torch.nn.functional as F
    dt = F.softplus(torch.randn((B, L, E), generator=gen, device=dev)) * 0.2
    Bm, Cm = (torch.randn((B, L, N), generator=gen, device=dev)
              for _ in range(2))
    x = torch.randn((B, L, E), generator=gen, device=dev)
    A = -torch.randn((E, N), generator=gen, device=dev).abs()
    return dt, Bm, Cm, x, A


def ulp_of(v):
    """The float32 spacing at |v| (a Python float)."""
    return float(np.spacing(np.float32(abs(v))))


def scan_bound(want):
    """SCAN_ULPS float32 ulps of max |want|."""
    return SCAN_ULPS * ulp_of(float(want.float().abs().max()))


def phase_scan_small(dev):
    import torch
    from repro_torch.kernels.selective_scan.kernel import selective_scan
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref
    from repro_torch.kernels.selective_scan import kernel as sk
    gen = torch.Generator(device=dev)
    worst, worst_bf16, worst_h, n = 0.0, 0.0, 0.0, 0
    for B, L, E, N in SCAN_CASES:
        gen.manual_seed(L * 1000 + E)
        dt, Bm, Cm, x, A = scan_inputs(gen, B, L, E, N, dev)
        for dtype in (torch.float32, torch.bfloat16):
            ins = [t.to(dtype) for t in (dt, Bm, Cm, x)]
            plain = selective_scan_ref(*ins, A)
            got = selective_scan(*ins, A)
            torch.cuda.synchronize()
            what = f"selective_scan B{B} L{L} E{E} N{N} {dtype}"
            check(got.dtype == dtype and got.shape == x.shape, what)
            bound = scan_bound(plain)
            if dtype == torch.float32:
                err = float(torch.max(torch.abs(got - plain)))
                check(err <= bound, f"{what}: max |d| {err:.3g} > {bound:.3g}")
                worst = max(worst, err / ulp_of(float(plain.abs().max())))
            else:
                u, at = bf16_ulps(got, plain, floor=bound)
                check(u <= 1.0, f"{what}: {u:.2f} bf16 ulps at |y| {at:.3g}")
                worst_bf16 = max(worst_bf16, u)
            n += 1
        # the launch that keeps the state checkpoints: the same y, and
        # the plain trajectory's states
        y, h = sk._launch(dt, Bm, Cm, x, A, ckpt=True)
        py, ph = selective_scan_ref(dt, Bm, Cm, x, A,
                                    ckpt_chunk=sk.ckpt_chunk(N))
        check(torch.equal(y, selective_scan(dt, Bm, Cm, x, A)),
              "the checkpointing launch changed y")
        err = float(torch.max(torch.abs(h - ph)))
        check(h.shape == ph.shape and err <= scan_bound(ph),
              f"checkpoints B{B} L{L} E{E} N{N}: max |d| {err:.3g}")
        worst_h = max(worst_h, err / ulp_of(float(ph.abs().max())))
    x = torch.randn((1, 8, 4), device=dev).to(torch.bfloat16)
    x.requires_grad_()
    try:
        selective_scan(x, torch.ones((1, 8, 2), device=dev).bfloat16(),
                       torch.ones((1, 8, 2), device=dev).bfloat16(), x,
                       -torch.ones((4, 2), device=dev)).sum().backward()
    except NotImplementedError:
        pass
    else:
        raise AssertionError("a bfloat16 backward through the scan op did "
                             "not raise")
    log(f"phase selective_scan: {n} kernel calls against the plain version "
        f"on the card (f32 within {worst:.2f} ulps of max |y|, bound "
        f"{SCAN_ULPS}; bf16 within {worst_bf16:.2f} bf16 ulp); the state "
        f"checkpoints within {worst_h:.2f} ulps of max |h|; a bfloat16 "
        "backward raises")


# --------------------------------------------------------------------------
# phases mamba prefill and serve: falcon-mamba-7b and hymba-1.5b at full
# width and depth
# --------------------------------------------------------------------------

def phase_mamba_prefill(dev, arch):
    """The prefill step and forward of a Mamba or hybrid model; the last
    layer's scan held against the plain version on its own inputs."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.kernels.dispatch import LAUNCHES, reset_launches
    from repro_torch.kernels.selective_scan import ops as scan_ops
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import forward, init_params, param_count

    cfg = get_config(arch)
    params, init_s = timed(lambda: init_params(
        torch.Generator(device=dev).manual_seed(0), cfg))
    check(param_count(params) == MAMBA_PARAMS[arch], f"{arch} parameters")
    tokens = torch.from_numpy(TokenStream(
        n_clients=1, vocab=cfg.vocab_size, batch=PREFILL_B,
        seq=PREFILL_S).batch_at(0)[0]).long().to(dev)
    batch = {"tokens": tokens}
    prefill = build_prefill_step(cfg)
    reset_launches()            # the prefill main path starts here
    last, first_s = timed(lambda: prefill(params, batch))
    launches = dict(LAUNCHES)   # and ends here
    check(launches == {"selective_scan": cfg.n_layers},
          f"{arch} prefill step launches {launches}")
    check(last.shape == (PREFILL_B, cfg.vocab_size)
          and bool(torch.isfinite(last).all()), f"{arch} prefill logits")
    torch.cuda.reset_peak_memory_stats(dev)
    _, prefill_s = timed(lambda: prefill(params, batch))
    step_peak = torch.cuda.max_memory_allocated(dev)
    log(profile_line(f"{arch} prefill step", *device_profile(
        lambda: prefill(params, batch))))
    # forward keeps the last layer's scan operands: the kernel is held to
    # its plain version on the model's own activations
    op, seen = scan_ops.selective_scan_op, []

    def keep_last(*args):
        out = op(*args)
        seen[:] = [(args, out)]
        return out

    scan_ops.selective_scan_op = keep_last
    reset_launches()
    try:
        with torch.no_grad():
            logits, fwd_s = timed(lambda: forward(params, cfg, batch)[0])
    finally:
        scan_ops.selective_scan_op = op
    check(dict(LAUNCHES) == {"selective_scan": cfg.n_layers},
          f"{arch} forward launches {dict(LAUNCHES)}")
    check(bool(torch.isfinite(logits).all()), f"{arch}: non-finite logits")
    args, out = seen.pop()
    plain, plain_s = timed(lambda: selective_scan_ref(*args))
    layer_err = float(torch.max(torch.abs(out - plain)))
    layer_bound = scan_bound(plain)
    check(layer_err <= layer_bound, f"{arch} layer {cfg.n_layers - 1} scan "
          f"vs plain on its own inputs: {layer_err:.3g} > {layer_bound:.3g}")
    layer_ulps = layer_err / ulp_of(float(plain.abs().max()))
    del args, out, plain
    # the step unembeds one position, forward all of them
    step_err = float(torch.max(torch.abs(logits[:, -1] - last)))
    check(step_err <= 1e-5 * float(last.abs().max()),
          f"{arch} prefill step vs forward's last position: {step_err:.3g}")
    scale = float(logits.abs().max())
    del logits
    torch.cuda.empty_cache()
    log(f"phase prefill ({arch}): {cfg.n_layers} layers, "
        f"{param_count(params):,} params (init {init_s:.2f} s); B={PREFILL_B}"
        f" S={PREFILL_S}: prefill step {first_s:.3f} s first, "
        f"{prefill_s:.3f} s second (peak {step_peak / 1e9:.2f} GB); forward "
        f"{fwd_s:.3f} s, max |logit| {scale:.3f}; layer {cfg.n_layers - 1} "
        f"kernel vs plain on its own inputs max |d| {layer_err:.3g} = "
        f"{layer_ulps:.2f} ulps of max |y| (bound {SCAN_ULPS}; plain version "
        f"{plain_s:.2f} s); step vs forward max |d| {step_err:.3g}; launches "
        f"{launches}")
    return cfg, params, tokens, launches


# --------------------------------------------------------------------------
# selective_scan at the prefill shapes: time, bound, plain
# --------------------------------------------------------------------------

def scan_bound_ms(B, L, E, N, esize):
    """(bytes ms, exp ms, f32 ms): dt, x, y and Bm, Cm read or written
    once (A too); one exp per state update on the special-function units;
    six float32 operations per update (dt*A, dx*B, decay*h, + drive,
    h*C, + acc) on the CUDA cores."""
    updates = B * L * E * N
    nbytes = 3 * B * L * E * esize + 2 * B * L * N * esize + E * N * 4
    return (nbytes / PEAK_BYTES_PER_S * 1e3,
            updates / PEAK_SFU_OPS_PER_S * 1e3,
            6 * updates / PEAK_F32_OPS_PER_S * 1e3)


def phase_scan_width(dev, launches):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.selective_scan.kernel import warps
    from repro_torch.kernels.selective_scan.ops import selective_scan_op
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref
    gen = torch.Generator(device=dev).manual_seed(4)
    row = None
    for arch in MAMBA_PARAMS:
        B, L = PREFILL_B, PREFILL_S
        E, N = get_config(arch).d_inner, get_config(arch).ssm_state
        dt, Bm, Cm, x, A = scan_inputs(gen, B, L, E, N, dev)
        out = selective_scan_op(dt, Bm, Cm, x, A)
        ms = time_ms(lambda: selective_scan_op(dt, Bm, Cm, x, A), reps=25)
        plain, plain_s = timed(lambda: selective_scan_ref(dt, Bm, Cm, x, A))
        err = float(torch.max(torch.abs(out - plain)))
        bound = scan_bound(plain)
        check(err <= bound, f"selective_scan at {arch}'s shape: {err:.3g} > "
              f"{bound:.3g}")
        check(bool(torch.isfinite(out).all()), "non-finite scan output")
        bytes_ms, exp_ms, f32_ms = scan_bound_ms(B, L, E, N, 4)
        ops_ms = max(exp_ms, f32_ms)
        bound_ms = max(bytes_ms, ops_ms)
        log(f"time selective_scan ({arch}: B={B} L={L} E={E} N={N} f32): "
            f"{ms:.3f} ms (bound {bound_ms:.3f} ms: bytes {bytes_ms:.3f}, "
            f"exps {exp_ms:.3f}, f32 {f32_ms:.3f}; {bound_ms / ms:.0%} of "
            f"the roofline; {warps(B, E, N)} warps in flight, "
            f"{warps(B, E, N) / 132:.1f} an SM); plain version "
            f"{plain_s * 1e3:.1f} ms; kernel vs plain max |d| {err:.3g} = "
            f"{err / ulp_of(float(plain.abs().max())):.2f} ulps of max |y|")
        if row is None:     # the row's numbers: the falcon prefill shape
            row = {"name": "selective_scan", "route": "cuda",
                   "source": SCAN_SOURCE, "replaces": SCAN_REPLACES,
                   "launches": launches.get("selective_scan", 0),
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_s * 1e3,
                   "bound_ms": bound_ms,
                   "bound_by": "operations" if ops_ms >= bytes_ms
                   else "bytes",
                   "library_ms": None}
        del dt, Bm, Cm, x, A, out, plain
        torch.cuda.empty_cache()
    return row


# --------------------------------------------------------------------------
# the scan's backward: small shapes, then the train shapes
# --------------------------------------------------------------------------

def scan_bwd_compare(what, got, want):
    """The largest of max |kernel - plain| / max |plain| over the five
    gradients, and the largest max |kernel - plain|; fails past
    SCAN_BWD_RTOL or on a non-finite value."""
    import torch
    worst_rel, worst_abs = 0.0, 0.0
    for name, a, b in zip(SCAN_GRADS, got, want):
        check(a.shape == b.shape and bool(torch.isfinite(a).all()),
              f"{what} {name}: shape or non-finite")
        err = float(torch.max(torch.abs(a - b))) if a.numel() else 0.0
        scale = float(b.abs().max()) if b.numel() else 0.0
        rel = err / scale if scale else err
        check(rel <= SCAN_BWD_RTOL, f"{what} {name}: max |d| {err:.3g} = "
              f"{rel:.3g} x max |plain| > {SCAN_BWD_RTOL}")
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, err)
    return worst_rel, worst_abs


class ScanBwdStages:
    """The backward's carry pass and chunk kernel launched on their own,
    through the library's timing entry points, with the scratch of
    ``plan`` (split, groups), on the operands of one backward (outside
    the wrappers: not launches of the main path).  ``carry`` holds the
    carry pass's output (split only)."""

    def __init__(self, dt, Bm, Cm, x, A, h, g, plan):
        import ctypes
        import torch
        from repro_torch.kernels import build
        from repro_torch.kernels.selective_scan import kernel as sk
        lib = build.library("selective_scan")
        self.fc = lib.selective_scan_bwd_carry
        self.fk = lib.selective_scan_bwd_chunks
        self.fc.argtypes = sk._BWD_CARRY_SIGNATURE
        self.fk.argtypes = sk._BWD_CHUNKS_SIGNATURE
        self.fc.restype = self.fk.restype = ctypes.c_int
        B, L, E = x.shape
        N = Bm.shape[2]
        self.plan = plan
        self.carry, self.part, self.dA_part = sk._bwd_scratch(
            B, L, E, N, *plan, x.device)
        self.ddt, self.dx = torch.empty_like(x), torch.empty_like(x)
        self.ops = (dt, Bm, Cm, x, A, h, g)
        self.shape = (B, L, E, N)
        self.stream = torch.cuda.current_stream(x.device).cuda_stream

    def run_carry(self):
        dt, _, Cm, _, A, _, g = self.ops
        err = self.fc(dt.data_ptr(), Cm.data_ptr(), A.data_ptr(),
                      g.data_ptr(), self.carry.data_ptr(), *self.shape,
                      self.stream)
        check(err == 0, f"selective_scan_bwd_carry: cudaError_t {err}")

    def run_chunks(self):
        ptrs = [t.data_ptr() for t in self.ops]
        carry = self.carry.data_ptr() if self.plan[0] else None
        err = self.fk(*ptrs[:6], carry, ptrs[6], self.ddt.data_ptr(),
                      self.dx.data_ptr(), self.part.data_ptr(),
                      self.dA_part.data_ptr(), *self.shape,
                      int(self.plan[0]), self.plan[1], self.stream)
        check(err == 0, f"selective_scan_bwd_chunks: cudaError_t {err}")


def carries_compare(what, stages, want):
    """The carry pass's output against the plain backward's carries:
    within SCAN_BWD_RTOL x max |plain|; returns (relative error, bit for
    bit)."""
    import torch
    stages.run_carry()
    torch.cuda.synchronize()
    got = stages.carry
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"{what} carries: shape or non-finite")
    err = float(torch.max(torch.abs(got - want)))
    rel = err / max(float(want.abs().max()), 1e-30)
    check(rel <= SCAN_BWD_RTOL, f"{what} carries: {rel:.3g} x max |plain|")
    return rel, same_bits(got, want)


def phase_scan_bwd_small(dev):
    """The backward kernels against the plain backward on the same
    operands (the kernel forward's checkpoints), with the plan the card
    gives and with L split and walked whole whatever the shape, twice
    bit for bit, and the autograd op on the card against the kernels'
    own output; the carry pass alone against the plain backward's
    carries."""
    import torch
    from repro_torch.kernels.selective_scan import kernel as sk
    from repro_torch.kernels.selective_scan.ref import selective_scan_bwd_ref
    gen = torch.Generator(device=dev)
    worst, worst_carry, carry_bits = 0.0, 0.0, True
    plans = ((True, sk.BWD_GROUPS), (True, 1), (False, 1),
             (False, sk.WALK_GROUPS))
    for B, L, E, N in SCAN_BWD_CASES:
        gen.manual_seed(L * 1000 + E + 7)
        dt, Bm, Cm, x, A = scan_inputs(gen, B, L, E, N, dev)
        g = torch.randn((B, L, E), generator=gen, device=dev)
        _, h = sk._launch(dt, Bm, Cm, x, A, ckpt=True)
        got = sk._launch_bwd(dt, Bm, Cm, x, A, h, g)
        again = sk._launch_bwd(dt, Bm, Cm, x, A, h, g)
        torch.cuda.synchronize()
        what = f"selective_scan_bwd B{B} L{L} E{E} N{N}"
        check(all(same_bits(a, b) for a, b in zip(got, again)),
              f"{what}: two launches differ")
        *want, carries = selective_scan_bwd_ref(
            dt, Bm, Cm, x, A, h, g, sk.ckpt_chunk(N), return_carries=True)
        worst = max(worst, scan_bwd_compare(what, got, want)[0])
        for plan in plans:
            forced = sk._launch_bwd(dt, Bm, Cm, x, A, h, g, plan=plan)
            worst = max(worst, scan_bwd_compare(f"{what} plan {plan}",
                                                forced, want)[0])
        rel, bits = carries_compare(
            what, ScanBwdStages(dt, Bm, Cm, x, A, h, g, plans[0]), carries)
        worst_carry, carry_bits = max(worst_carry, rel), carry_bits and bits
        ins = [t.clone().requires_grad_() for t in (dt, Bm, Cm, x, A)]
        sk.selective_scan(*ins).backward(g)
        check(all(same_bits(t.grad, a) for t, a in zip(ins, got)),
              f"{what}: the autograd op's gradients are not the kernel's")
    log(f"phase selective_scan backward: {len(SCAN_BWD_CASES)} shapes, each "
        f"gradient within {worst:.3g} x max |plain| of the plain backward "
        f"(bound {SCAN_BWD_RTOL}) with the card's plan and with plans "
        f"{', '.join(map(str, plans))} (split, groups); two launches "
        "bit-identical; the autograd "
        "op on the card gives the kernel's gradients; the carry pass within "
        f"{worst_carry:.3g} x max |plain| of the plain backward's carries "
        f"(bit-identical: {carry_bits})")


def scan_bwd_bound_ms(B, L, E, N, chunk):
    """(bytes ms, exp ms, f32 ms) of the backward: dt, x, g, Bm, Cm, A
    and the checkpoints read once, ddt, dx, dB, dC and dA written once;
    one exp and SCAN_BWD_OPS float32 operations a state update."""
    updates = B * L * E * N
    nbytes = 4 * (5 * B * L * E + 4 * B * L * N + 2 * E * N
                  + B * -(-L // chunk) * E * N)
    return (nbytes / PEAK_BYTES_PER_S * 1e3,
            updates / PEAK_SFU_OPS_PER_S * 1e3,
            SCAN_BWD_OPS * updates / PEAK_F32_OPS_PER_S * 1e3)


def chunked_route_seconds(dt, Bm, Cm, x, A, g, chunk):
    """One layer's scan forward and backward the plain way: autograd
    through models/mamba.py's chunked scan (called directly: on the card
    the model takes the kernels)."""
    import torch
    from repro_torch.models.mamba import selective_scan_chunked
    ins = [t.detach().clone().requires_grad_() for t in (dt, Bm, Cm, x, A)]
    h0 = torch.zeros((x.shape[0], x.shape[2], A.shape[1]), device=x.device)

    def run():
        y, _ = selective_scan_chunked(*ins, h0, chunk)
        return torch.autograd.grad(y, ins, g)

    grads, seconds = timed(run)
    del grads, ins
    return seconds


def phase_scan_bwd_width(dev, launches):
    """The backward kernel at both train shapes (B = 1, L = 4096): against
    the plain backward, twice bit for bit, timed against its bound, the
    plain backward and the plain route, its carry pass and chunk kernel
    timed alone, the carries against the plain backward's; the forward
    timed with and without the checkpoints, in turns.  Returns the kernels line's row (the
    shape of hymba-1.5b, whose train run at full depth gave ``launches``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.selective_scan import kernel as sk
    from repro_torch.kernels.selective_scan.ref import selective_scan_bwd_ref
    gen = torch.Generator(device=dev).manual_seed(5)
    row = None
    for arch in MAMBA_PARAMS:
        cfg = get_config(arch)
        B, L, E, N = TRAIN_B, TRAIN_S, cfg.d_inner, cfg.ssm_state
        chunk = sk.ckpt_chunk(N)
        dt, Bm, Cm, x, A = scan_inputs(gen, B, L, E, N, dev)
        g = torch.randn((B, L, E), generator=gen, device=dev)
        fwd = {False: [], True: []}
        for ckpt in (False, True, True, False):
            fwd[ckpt].append(time_ms(
                lambda: sk._launch(dt, Bm, Cm, x, A, ckpt=ckpt), reps=25))
        _, h = sk._launch(dt, Bm, Cm, x, A, ckpt=True)
        got = sk._launch_bwd(dt, Bm, Cm, x, A, h, g)
        again = sk._launch_bwd(dt, Bm, Cm, x, A, h, g)
        torch.cuda.synchronize()
        what = f"selective_scan_bwd at {arch}'s train shape"
        check(all(same_bits(a, b) for a, b in zip(got, again)),
              f"{what}: two launches differ")
        # events around each call, as every row of the kernels line; the
        # queued time (the wrapper's Python overlapped) beside it
        ms = time_ms(lambda: sk._launch_bwd(dt, Bm, Cm, x, A, h, g),
                     reps=25)
        queued_ms = time_ms_queued(
            lambda: sk._launch_bwd(dt, Bm, Cm, x, A, h, g), reps=25)
        slots = sk.bwd_slots(dev, N)
        plan = sk.bwd_plan(B, E, N, slots)
        # both plans whatever the card chose, each whole and its kernels
        # alone: split (the carry pass, one block a chunk) and the walk
        # over L (the walk's groups as the plan would give them)
        walk = (False, plan[1] if not plan[0] else 1)
        split = (True, sk.BWD_GROUPS)
        plan_ms, stage_ms = {}, {}
        for p in (split, walk):
            plan_ms[p] = time_ms(lambda: sk._launch_bwd(
                dt, Bm, Cm, x, A, h, g, plan=p), reps=25)
            stages = ScanBwdStages(dt, Bm, Cm, x, A, h, g, p)
            if p[0]:
                stage_ms["carry pass"] = time_ms(stages.run_carry, reps=25)
            stage_ms[f"chunk kernel {p}"] = time_ms(stages.run_chunks,
                                                    reps=25)
            del stages
        (*want, carries), plain_s = timed(lambda: selective_scan_bwd_ref(
            dt, Bm, Cm, x, A, h, g, chunk, return_carries=True))
        rel, err = scan_bwd_compare(what, got, want)
        for p in (split, walk):
            scan_bwd_compare(f"{what} plan {p}", sk._launch_bwd(
                dt, Bm, Cm, x, A, h, g, plan=p), want)
        carry_rel, carry_bits = carries_compare(
            what, ScanBwdStages(dt, Bm, Cm, x, A, h, g, split), carries)
        del got, again, want, carries
        torch.cuda.empty_cache()
        route_s = chunked_route_seconds(dt, Bm, Cm, x, A, g, cfg.scan_chunk)
        torch.cuda.empty_cache()
        bytes_ms, exp_ms, f32_ms = scan_bwd_bound_ms(B, L, E, N, chunk)
        ops_ms = max(exp_ms, f32_ms)
        bound_ms = max(bytes_ms, ops_ms)
        log(f"time selective_scan_bwd ({arch}: B={B} L={L} E={E} N={N} f32): "
            f"{ms:.3f} ms (events around each call; {queued_ms:.3f} ms a "
            f"call over 25 queued) (bound {bound_ms:.3f} ms: bytes "
            f"{bytes_ms:.3f}, exps {exp_ms:.3f}, f32 {f32_ms:.3f}; "
            f"{bound_ms / ms:.0%} of the roofline; plan (split, groups) "
            f"{plan} (the card holds {slots} chunk-kernel blocks at once); "
            f"split {split} "
            f"{plan_ms[split]:.3f} ms, walk {walk} {plan_ms[walk]:.3f} ms; "
            "alone: " + ", ".join(f"{k} {v:.3f} ms"
                                  for k, v in stage_ms.items())
            + f"; the carries within {carry_rel:.3g} x max |plain| of the "
            f"plain backward's, bit-identical: {carry_bits}); plain backward "
            f"{plain_s * 1e3:.1f} ms; the plain route (autograd through the "
            f"chunked scan, chunk {cfg.scan_chunk}, one layer's forward and "
            f"backward) {route_s * 1e3:.1f} ms; kernel vs plain within "
            f"{rel:.3g} x max |plain| (max |d| {err:.3g}); two launches "
            f"bit-identical; forward without / with checkpoints "
            f"{', '.join(f'{t:.3f}' for t in fwd[False])} / "
            f"{', '.join(f'{t:.3f}' for t in fwd[True])} ms")
        if arch == "hymba-1.5b":
            row = {"name": "selective_scan_bwd", "route": "cuda",
                   "source": SCAN_SOURCE, "replaces": SCAN_BWD_REPLACES,
                   "launches": launches.get("selective_scan_bwd", 0),
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_s * 1e3,
                   "bound_ms": bound_ms,
                   "bound_by": "operations" if ops_ms >= bytes_ms
                   else "bytes",
                   "library_ms": None}
        del dt, Bm, Cm, x, A, g, h
        torch.cuda.empty_cache()
    return row


# --------------------------------------------------------------------------
# the explicit-noise kernels of the leafwise codecs: small shapes
# --------------------------------------------------------------------------

def same_bits(a, b):
    """Bit-for-bit equality of two float32 or bfloat16 tensors, except
    that a NaN equals any NaN (the bfloat16 narrowing of a NaN may change
    its payload)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = {4: torch.int32, 2: torch.int16}[a.element_size()]
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a[~nan].contiguous().view(view), b[~nan].contiguous().view(view))


def phase_dequantize_small(dev):
    """Both kernels against their plain versions at the CPU tests'
    shapes: QSGD bit-exact given the kernel's norms (the sign of every
    zero included), norms within NORM_ULPS of the plain sum, levels 1 / 7
    / 127 / 255, zero buckets, float32 and bfloat16; natural bit-exact on
    ±0, subnormals, ±Inf, NaN and the exponent-254 carry, both types."""
    import torch
    from repro_torch.kernels.natural.kernel import natural_compress_2d
    from repro_torch.kernels.natural.ref import natural_compress_2d_ref
    from repro_torch.kernels.qsgd.kernel import qsgd_dequantized
    from repro_torch.kernels.qsgd.ref import (dequantize_with_noise,
                                              qsgd_dequantized_ref)
    rng = np.random.default_rng(6)
    worst, calls = 0.0, 0
    for nb, b in ((4, 128), (3, 2048), (2, 384), (3, 100), (5, 7)):
        x = rng.normal(size=(nb, b)).astype(np.float32)
        x[1] = 0.0
        u = rng.random((nb, b), dtype=np.float32)
        ud = torch.from_numpy(u).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            xd = torch.from_numpy(x).to(dev).to(dtype)
            for levels in (1, 7, 127, 255):
                norms = torch.empty((nb, 1), device=dev)
                got = qsgd_dequantized(xd, ud, levels=levels,
                                       norms_out=norms)
                want = qsgd_dequantized_ref(xd, ud, levels, norms=norms)
                what = f"qsgd_dequantized ({nb}, {b}) {dtype} levels {levels}"
                check(got.dtype == dtype and same_bits(got, want), what)
                check(float(norms[1]) == 0.0 and not got[1].any(),
                      f"{what}: zero bucket")
                _, plain = dequantize_with_noise(xd, ud, levels)
                worst = max(worst, ulps(plain, norms))
                cpu = qsgd_dequantized_ref(xd.cpu(), ud.cpu(), levels,
                                           norms=norms.cpu())
                check(same_bits(got.cpu(), cpu), f"{what}: vs the CPU")
                calls += 1
    check(worst <= NORM_ULPS, f"bucket norms {worst} ulps from the plain sum")
    for shape in ((3, 6, 128), (3, 2048), (7, 8), (5, 3)):
        x = natural_buffer(rng, 1, 4, 2048).reshape(-1)[:np.prod(shape)] \
            .reshape(shape)
        u = rng.random(shape, dtype=np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            xd = torch.from_numpy(x).to(dev).to(dtype)
            ud = torch.from_numpy(u).to(dev)
            got = natural_compress_2d(xd, ud)
            what = f"natural_compress_2d {shape} {dtype}"
            check(got.dtype == dtype and same_bits(
                got, natural_compress_2d_ref(xd, ud)), what)
            check(same_bits(got.cpu(), natural_compress_2d_ref(
                xd.cpu(), ud.cpu())), f"{what}: vs the CPU")
            calls += 1
    torch.cuda.synchronize()
    log(f"phase dequantize: {calls} kernel calls against the plain versions "
        f"on the card and on the CPU: qsgd_dequantized bit-exact given its "
        f"norms (norms within {worst:g} ulps of the plain sum, bound "
        f"{NORM_ULPS}), natural_compress_2d bit-exact (±0, subnormals, ±Inf, "
        "NaN, carries; float32 and bfloat16)")
    return worst


# --------------------------------------------------------------------------
# phase train: stablelm-1.6b at full width and depth through the leafwise
# train step
# --------------------------------------------------------------------------

def train_profile(fn):
    """Run ``fn`` once under torch.profiler: (wall ms, {"gemm" |
    "attention" | "draw" | "kernel" | "scan" | "scan_bwd" |
    "elementwise": device ms}, kernel count).  "gemm" is every matrix
    product (the attention's included), "attention" its softmax, "kernel"
    the codecs' hand-written kernels, "scan" and "scan_bwd" the selective
    scan's forward and backward kernels; "draw" is the threefry draws'
    device time, bracketed by CUDA events around each draw (one stream:
    nothing else runs in between), and comes out of the elementwise
    kernels, which are the rest.  The device ms do not overlap."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import prng
    draw, spans = prng._draw, []

    def timed_draw(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = draw(*args)
        end.record()
        spans.append((start, end))
        return out

    prng._draw = timed_draw
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        prng._draw = draw
    by_kind = {"gemm": 0.0, "attention": 0.0, "draw": 0.0, "kernel": 0.0,
               "scan": 0.0, "scan_bwd": 0.0, "elementwise": 0.0}
    count = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.key.lower()
        kind = "kernel" if ("qsgd_dequantized" in name
                            or "natural_noise" in name) else \
            "scan_bwd" if ("scan_bwd_" in name
                           or "sum_middle" in name) else \
            "scan" if "scan_kernel<" in name else \
            "gemm" if "gemm" in name or "gemv" in name else \
            "attention" if "softmax" in name else "elementwise"
        by_kind[kind] += e.self_device_time_total / 1e3
        count += e.count
    by_kind["draw"] = min(sum(s.elapsed_time(e) for s, e in spans),
                          by_kind["elementwise"])
    by_kind["elementwise"] -= by_kind["draw"]
    return wall_ms, by_kind, count


def train_line(what, wall_ms, by_kind, count):
    busy = sum(by_kind.values())
    if not count:
        return f"profile {what}: the profiler saw no device activity"
    return (f"profile {what}: wall {wall_ms:.1f} ms, {count} kernels, device "
            f"busy {busy:.1f} ms (idle share {1 - busy / wall_ms:.1%}): " +
            ", ".join(f"{k} {v:.1f} ms ({v / wall_ms:.1%})"
                      for k, v in by_kind.items()
                      if v or k not in ("scan", "scan_bwd")))


def phase_train(dev, name, arch="stablelm-1.6b", layers=None):
    """``arch`` at full width (and ``layers`` of its layers, all by
    default), 2 clients x one 4096-token sequence, f32, remat on, dense
    attention: build_train_step with leafwise ``name`` compression both
    ways, forced xi TRAIN_XI.  Every leaf's codec runs the kernel: 2 fresh
    rounds x leaves x 2 links launches (44 for stablelm-1.6b).  A Mamba
    or hybrid model also runs the scan: its forward once a layer and
    client for each step's loss and again in each local step's recompute
    (remat), its backward once a layer and client in each local step; no
    other kernel runs.  Then one local and one fresh aggregation step
    under the profiler.  Returns the trained stacked params and the
    launch counts."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import L2GDHyper, init_state, make_compressor
    from repro_torch.core import make_plan, prng
    from repro_torch.core.rollout import window_streams
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import TokenStream
    from repro_torch.fl.ledger import BitsLedger
    from repro_torch.kernels.dispatch import LAUNCHES, reset_launches
    from repro_torch.launch.steps import build_train_step, param_shapes
    from repro_torch.launch.train import init_stacked_params
    from repro_torch.models import param_count

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    check(cfg.remat and cfg.attn_impl == "dense",
          "the train phase's configuration")
    n = TRAIN_CLIENTS
    torch.cuda.reset_peak_memory_stats(dev)
    params, init_s = timed(lambda: init_stacked_params(cfg, n, 0, dev))
    n_params = TRAIN_PARAMS[(arch, layers)]
    check(param_count(params) == n * n_params, "parameter count")
    leaves = len(tree_leaves(params))
    check(arch != "stablelm-1.6b" or leaves == STABLELM_LEAVES, "leaf count")
    stream = TokenStream(n_clients=n, vocab=cfg.vocab_size, batch=TRAIN_B,
                         seq=TRAIN_S)
    batches = [{"tokens": torch.from_numpy(stream.batch_at(k)).to(dev)}
               for k in range(len(TRAIN_XI) + 2)]
    comp = make_compressor(name)
    hp = L2GDHyper(eta=0.1, lam=0.5, p=0.2, n=n)    # the train CLI's
    step = build_train_step(cfg, hp, comp, comp)
    plan = make_plan(comp, param_shapes(cfg), transport="leafwise")
    bits = plan.round_bits()
    xis, keys = window_streams(prng.PRNGKey(0), hp.p, 0, len(TRAIN_XI) + 2,
                               TRAIN_XI + [0, 1])
    state = init_state(params)
    del params
    ledger = BitsLedger(n)
    reset_launches()            # the train main path starts here
    times, losses, branches = [], [], []
    for k, xi in enumerate(TRAIN_XI):
        (state, metrics), seconds = timed(
            lambda: step(state, batches[k], xi, keys[k]))
        times.append(seconds)
        losses.append(float(metrics["loss"]))
        branches.append(metrics["branch"])
        if metrics["branch"] == 1:
            ledger.record_round(bits, bits, step=k)
    launches = dict(LAUNCHES)   # and ends here
    peak = torch.cuda.max_memory_allocated(dev)
    kernel = LEAFWISE_KERNELS[name]
    check(branches == [0, 1, 2, 0, 1], f"branches {branches}")
    want = {kernel: 2 * 2 * leaves}
    if cfg.mixer != "gqa":      # every layer of both families has a scan
        local = branches.count(0)
        want["selective_scan"] = n * cfg.n_layers * (len(TRAIN_XI) + local)
        want["selective_scan_bwd"] = n * cfg.n_layers * local
    check(launches == want, f"train {arch} ({name}) launches {launches}, "
          f"the path implies {want}")
    check(all(np.isfinite(losses)), f"losses {losses}")
    check(peak <= TRAIN_PEAK, f"peak {peak / 1e9:.2f} GB")
    check(ledger.rounds == 2 and ledger.bits_per_client == 4 * bits,
          "ledger")
    for leaf in tree_leaves(state.params):
        check(bool(torch.isfinite(leaf).all()), "non-finite params")
    local = [t for t, b in zip(times, branches) if b == 0]
    fresh = [t for t, b in zip(times, branches) if b == 1]
    log(f"phase train ({name}): {arch}, {cfg.n_layers} layers, {n} clients x "
        f"{n_params:,} params (init {init_s:.2f} s), B={TRAIN_B} "
        f"S={TRAIN_S} a client, leafwise both ways; step seconds "
        f"{[round(t, 3) for t in times]} (local {np.mean(local):.3f}, "
        f"fresh aggregation {np.mean(fresh):.3f}, cached {times[2]:.3f}); "
        f"losses {[round(v, 5) for v in losses]}; peak allocated "
        f"{peak / 1e9:.2f} GB; bits/n {ledger.bits_per_client:.6e} "
        f"({ledger.rounds} rounds x {bits:.0f} bits a message each way); "
        f"launches {launches}")
    for what, k in (("local step", 5), ("fresh aggregation step", 6)):
        out = []
        log(train_line(f"train {arch} ({name}) {what}", *train_profile(
            lambda: out.append(step(state, batches[k], xis[k], keys[k])))))
        state = out[0][0]
    return state.params, launches


def phase_train_width(dev, params, launches, name, norm_ulps):
    """The phase's kernel on the run's largest leaf (w_gate, 2 x
    276,824,064 elements) against its plain version and its bound, with
    the draw that feeds it timed at two chunk sizes."""
    import torch
    from repro_torch.core import flatbuf, prng
    from repro_torch.kernels.natural.kernel import natural_compress_2d
    from repro_torch.kernels.natural.ref import natural_compress_2d_ref
    from repro_torch.kernels.qsgd.kernel import qsgd_dequantized
    from repro_torch.kernels.qsgd.ref import (dequantize_with_noise,
                                              qsgd_dequantized_ref)

    x = params["layers"]["ffn"]["w_gate"]
    keys = prng.split(prng.PRNGKey(9), x.shape[0])
    shape = x.shape[1:] if name == "natural" else \
        (x[0].numel() // 2048, 2048)
    draw_ms, chunk = {}, prng.DRAW_CHUNK
    try:
        for c in (chunk // 4, chunk):
            prng.DRAW_CHUNK = c
            draw_ms[c] = time_ms(lambda: prng.tensor_uniform(keys, shape,
                                                             dev),
                                 reps=2, warmup=1)
    finally:
        prng.DRAW_CHUNK = chunk
    noise = prng.tensor_uniform(keys, shape, dev)
    kernel = LEAFWISE_KERNELS[name]
    if name == "natural":
        xs, us = x, noise
        fn = lambda: natural_compress_2d(xs, us)
        got = fn()
        want = natural_compress_2d_ref(xs, us)
        check(same_bits(got, want), "natural_compress_2d at width")
        err = 0.0
        plain_fn = lambda: natural_compress_2d_ref(xs, us)
    else:
        xs = flatbuf.bucketize(x.reshape(x.shape[0], -1), 2048) \
            .reshape(-1, 2048)
        us = noise.reshape(-1, 2048)
        norms = torch.empty((xs.shape[0], 1), device=dev)
        fn = lambda: qsgd_dequantized(xs, us, levels=127)
        got = qsgd_dequantized(xs, us, levels=127, norms_out=norms)
        want = qsgd_dequantized_ref(xs, us, 127, norms=norms)
        check(same_bits(got, want), "qsgd_dequantized at width, given norms")
        own, plain_norms = dequantize_with_noise(xs, us, 127)
        norm_ulps = max(norm_ulps, ulps(plain_norms, norms))
        check(norm_ulps <= NORM_ULPS, f"norms {norm_ulps} ulps at width")
        err = float(torch.max(torch.abs(own - got)))
        check(bool(torch.all(torch.abs(own - got)
                             <= plain_norms / 127 * 1.000001)),
              "qsgd_dequantized beyond one level of its plain version")
        del own, plain_norms
        plain_fn = lambda: qsgd_dequantized_ref(xs, us, 127)
    del got, want
    torch.cuda.empty_cache()
    ms = time_ms(fn, reps=25)
    plain_ms = time_ms(plain_fn, reps=1, warmup=1)
    nbytes = 12 * xs.numel()    # x and the noise read, y written
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    # float32 operations per element: QSGD square and add (norm), abs,
    # div, mul, floor, sub, compare, add, sign, two multiplies (11);
    # natural mask, convert, multiply, compare, mask, add (6, int32)
    ops_ms = (11 * xs.numel() / PEAK_F32_OPS_PER_S if name == "qsgd" else
              6 * xs.numel() / PEAK_I32_OPS_PER_S) * 1e3
    log(f"time {kernel} ({tuple(xs.shape)}, the largest leaf of the train "
        f"run): {ms:.3f} ms (bound {max(bytes_ms, ops_ms):.3f} ms, "
        f"{nbytes / 1e9:.3f} GB; {bytes_ms / ms:.0%} of the memory "
        f"roofline); plain version {plain_ms:.1f} ms; its threefry noise "
        f"draw " + ", ".join(f"{v:.1f} ms (chunk {c})"
                             for c, v in draw_ms.items()) +
        (f"; norms within {norm_ulps:g} ulps; max |kernel - plain| "
         f"{err:.3g}" if name == "qsgd" else "; bit-exact"))
    return {"name": kernel, "route": "cuda",
            "source": DEQUANT_SOURCES[kernel],
            "replaces": DEQUANT_REPLACES[kernel],
            "launches": launches.get(kernel, 0), "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


# --------------------------------------------------------------------------
# phase model grad: the card's gradient of a 2-layer hymba-1.5b at full
# width against the CPU's
# --------------------------------------------------------------------------

def phase_model_grad(dev):
    """One client's loss and gradient of hymba-1.5b at full width and
    MODEL_GRAD_LAYERS layers on one sequence of MODEL_GRAD_S tokens: on
    the card through the scan kernels (forward, remat's recompute,
    backward), on the CPU through the chunked scan under autograd, from
    the same params.  Each leaf within MODEL_GRAD_RTOL x its max."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_flatten, tree_unflatten
    from repro_torch.data import TokenStream
    from repro_torch.kernels.dispatch import LAUNCHES, reset_launches
    from repro_torch.models import init_params, loss_fn

    cfg = dataclasses.replace(get_config("hymba-1.5b"),
                              n_layers=MODEL_GRAD_LAYERS)
    params = init_params(torch.Generator(device=dev).manual_seed(3), cfg)
    leaves, treedef = tree_flatten(params)
    names = tree_flatten(_key_paths(params))[0]
    del params
    tokens = torch.from_numpy(TokenStream(
        n_clients=1, vocab=cfg.vocab_size, batch=1,
        seq=MODEL_GRAD_S).batch_at(0)[0]).long()

    def grads(device):
        own = [a.detach().to(device).requires_grad_() for a in leaves]
        loss, _ = loss_fn(tree_unflatten(treedef, own), cfg,
                          {"tokens": tokens.to(device)})
        return loss.detach(), torch.autograd.grad(loss, own)

    reset_launches()
    (loss, got), gpu_s = timed(lambda: grads(dev))
    launches = dict(LAUNCHES)
    want_launches = {"selective_scan": cfg.n_layers * (2 if cfg.remat else 1),
                     "selective_scan_bwd": cfg.n_layers}
    check(launches == want_launches, f"model grad launches {launches}")
    t0 = time.perf_counter()
    cpu_loss, want = grads("cpu")
    cpu_s = time.perf_counter() - t0
    loss_rel = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
    check(loss_rel <= MODEL_GRAD_RTOL, f"model loss {loss_rel:.3g}")
    worst, at = 0.0, None
    for i, (a, b) in enumerate(zip(got, want)):
        check(bool(torch.isfinite(a).all()), "non-finite gradient")
        rel = float(torch.max(torch.abs(a.cpu() - b))) \
            / max(float(b.abs().max()), 1e-30)
        if rel >= worst:
            worst, at = rel, i
    check(worst <= MODEL_GRAD_RTOL, f"model gradient leaf {names[at]}: "
          f"{worst:.3g} x max |cpu| > {MODEL_GRAD_RTOL}")
    log(f"phase model grad: hymba-1.5b at full width, {cfg.n_layers} layers "
        f"(remat {cfg.remat}), one sequence of {MODEL_GRAD_S} tokens: the "
        f"card's gradient ({gpu_s:.2f} s; launches {launches}) against the "
        f"CPU's chunked scan under autograd ({cpu_s:.1f} s): loss within "
        f"{loss_rel:.3g}, the worst of {len(want)} leaves {names[at]} within "
        f"{worst:.3g} x its max (bound {MODEL_GRAD_RTOL})")


def _key_paths(tree, path=""):
    """The nested dict ``tree`` with each leaf replaced by its key path."""
    if isinstance(tree, dict):
        return {key: _key_paths(val, f"{path}.{key}" if path else key)
                for key, val in tree.items()}
    return path


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build   # fails outside a checkout

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    log(smi[0])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # full float32 in the model's matrix products (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s")

    worst = phase_kernels_small(dev)
    phase_natural_kernels_small(dev)
    phase_paper(dev)
    phase_paper_natural(dev)
    phase_leafwise(dev)
    x, launches = phase_width(dev)
    rows = phase_width_kernels(x, launches, worst)
    del x
    torch.cuda.empty_cache()
    x, launches = phase_width_natural(dev)
    rows += phase_width_kernels_natural(x, launches)
    del x
    torch.cuda.empty_cache()
    phase_flash_small(dev)
    cfg, params, tokens, launches = phase_prefill(dev)
    phase_serve(dev, cfg, params, tokens)
    del params
    torch.cuda.empty_cache()
    rows.append(phase_flash_width(dev, launches))
    phase_scan_small(dev)
    phase_scan_bwd_small(dev)
    prefill_launches = {}
    for arch in MAMBA_PARAMS:
        cfg, params, tokens, prefill_launches[arch] = \
            phase_mamba_prefill(dev, arch)
        phase_serve(dev, cfg, params, tokens)
        del params
        torch.cuda.empty_cache()
    rows.append(phase_scan_width(dev, prefill_launches["falcon-mamba-7b"]))
    norm_ulps = phase_dequantize_small(dev)
    for name in ("natural", "qsgd"):
        params, launches = phase_train(dev, name)
        rows.append(phase_train_width(dev, params, launches, name,
                                      norm_ulps))
        del params
        torch.cuda.empty_cache()
    train_launches = {}
    for arch, layers, name in MAMBA_TRAIN:
        params, train_launches[arch] = phase_train(dev, name, arch, layers)
        del params
        torch.cuda.empty_cache()
    rows.append(phase_scan_bwd_width(dev, train_launches["hymba-1.5b"]))
    phase_model_grad(dev)
    log(f"total: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
