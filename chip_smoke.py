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
           nothing, and every codec launches the threefry draw kernel
           once for each draw its CPU run makes;
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
  flash width  the kernel at the prefill shapes of stablelm-1.6b,
           granite-moe-1b-a400m (GQA, H = 16, Kv = 8),
           moonshot-v1-16b-a3b (D = 128) and internvl2-26b (H = 48,
           Kv = 8, D = 128) against the bound of its route
           (three split-TF32 passes on the tensor cores) and the CUDA-core
           float32 bound, its plain version and
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
           the codec's kernel (2 fresh rounds x 11 leaves x 2 links), as
           many of the threefry draw kernel (one a leaf draw; no draw
           reaches the plain int64 version) and no other, finite losses,
           peak memory <= 70 GB, the bits ledger; torch.profiler
           breakdowns of one local and one fresh aggregation step (the
           QSGD run: the local step only), the fresh step's threefry
           kernels one for each draw span;
  train width  each codec's kernel on that run's largest leaf (2 x
           276,824,064 elements) against its plain version and its
           bound, and the threefry draw that feeds it timed (again after
           each MoE train run below, on its expert stack);
  threefry width  the threefry draw kernel at that leaf's draw (2 keys
           x 276,824,064 counters) against its plain version (the int64
           passes) on the card, bit for bit in each finish (bits,
           uniform, bernoulli) at offset 0 and at an offset past 2^32
           whose counters cross into the next high word; timed in each
           finish beside its integer-throughput bound and the plain
           version; one draw's profile: the kernel and the keys' copy,
           no int64 elementwise operation;
  train (Mamba)  hymba-1.5b at full width and 16 of its 32 hybrid
           layers (leafwise natural) and falcon-mamba-7b at full width and
           4 of its 64 layers (leafwise QSGD), as the train phase: the scan
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
           leaf within 1e-4 x its max;
  paper fedavg  paper Fig 7 on the logistic regression (5 clients, d =
           124): L2GD at agg_scale 1 (400 steps) against FedAvg (200
           rounds), gap < 0.1; FedAvg with the flat QSGD compressed
           difference (qsgd_fused, one launch a client and round) and
           FedOpt (100 rounds each); error feedback with top-k inside
           L2GD against plain top-k; a 3 x 3 (p, lambda) grid of natural
           rollouts (natural_pack, natural_reduce, natural_fused); every
           run on the card against the port's CPU run: equal ledgers, xi
           traces and branch counts, final losses within 1e-3;
  fedavg lm  stablelm-1.6b at full width and depth (f32, remat, dense
           attention), 2 clients x one 4096-token sequence a round:
           run_fedavg 2 rounds with the leafwise QSGD difference and its
           EF memory (44 qsgd_dequantized launches), run_fedopt 2 rounds
           (server Adam, exact deltas, no kernel): seconds a round,
           peak <= 70 GB, the ledger exact;
  async width  the width trainer (8 clients x d = 411,060,224, packed
           uplink) on the async fault engine, QSGD then natural: the null
           plan equal in value to the synchronous run (flat and packed
           downlink); a chaos run (latency, drops, crashes, quorum 0.75,
           participation 0.75, stragglers folded at staleness weights
           0.5 and 0.25 by the reduce kernel): events conserved, the
           ledger from the delivery counts, peak <= 70 GB; participation
           0.5: half a round's bits; the chaos run at d = 1,057,408 on
           the card against the CPU (equal events and ledger; natural
           params equal in value, QSGD within one level);
  moe prefill / serve  granite-moe-1b-a400m at full width and depth,
           then moonshot-v1-16b-a3b and deepseek-v2-lite-16b at full width
           and 12 layers (f32, seeded random weights) on B = 2 sequences
           of 4096 tokens: build_prefill_step (GQA with attn_impl="flash":
           24 / 12 flash launches, 12 at D = 128; MLA: the dense latent
           prefill, no kernel), a profile with the MoE layer's spans
           (router, expert GEMMs, dispatch / combine), the dropped share
           at capacity factor 1.25, forward with flash against dense; then
           the serve phase at the capacity factor n_experts / k (nothing
           drops), deepseek's through the latent caches.  Each pair of
           runs that should agree (flash and dense, decode and forward)
           is held twice: the second run on its own routes, on the tokens
           that precede their sequence's first differing route; then
           taking the first run's routes, on every token, its flipped
           routes counted and held to a Poisson bound (flip_bound);
  route seeds  granite-moe-1b-a400m's flash-against-dense flips at four
           more seeds of its weights, each held to that bound;
  train (MoE)  the train phase for granite-moe-1b-a400m at full width and
           depth (natural, then QSGD: 48 launches each) and
           deepseek-v2-lite-16b at 3 layers (QSGD: 112), two local steps
           from one state bit-identical, profiles with the MoE spans;
           each run's kernel then on its expert stack as train width;
  moe grad  a 2-layer granite-moe-1b-a400m at full width on 512 tokens:
           the card's loss and gradient against the CPU's, routes first
           (the recompute routes as the forward; flips counted);
  fleet width  the width cell under bench_fleet's three cohorts
           (identity leafwise, natural flat, QSGD levels 4 narrow packed):
           a uniform fleet equal in value to its single plan on the
           synchronous engine and the async engine's chaos plan; the mixed
           fleet on both, the ledger charging sum_i round_bits(i) a round,
           the pack and reduce launches of each wire cohort, peak <= 70
           GB; the mixed fleet's mean against the plain codecs client by
           client under the key schedule, its levels-4 QSGD pack held
           and timed; three rounds of the bandwidth controller.
  checkpoint width  the width cell (QSGD packed uplink, flat downlink,
           4 steps in chunks of 2) with dense snapshots at both chunk
           boundaries through the CheckpointManager, n clients from the
           host's MemAvailable and the temp directory's free space (4 or
           2), resumed from step 2: params and cache equal to the
           committed snapshot of step 4, ledger, xi trace, losses and
           counters to the uninterrupted run's; the synchronous engine,
           then the async engine under the chaos plan at participation
           0.5; save()'s blocking time, the commits' and the restore's;
  serve store  stablelm-1.6b at full width and depth, 4 tenants (seeded
           perturbations of one base) in the DeltaModelStore, qsgd4 then
           natural: qsgd_pack / natural_pack at ingest, qsgd_unpack at
           materialize, each tenant equal to the plain decode on the
           card; the ServingEngine (LRU of 2, batches of 4, 16 + 16
           tokens) against a hand-run LRU trace, mixed-tenant logits
           equal to solo logits bit for bit; store.save -> load equal;
           TTFT, ms a token, residency against dense f32 and bf16;
  whisper prefill / serve  whisper-medium at full size (24 + 24 layers,
           f32, seeded random weights) on B = 2 sequences of 4096 tokens
           and 1500 stub frames: the prefill step (dense attention, as
           the reference's: no kernel) timed and profiled, held against
           forward's last position; the frames' normal draw on the card
           against the host's; then the serve phase with the cross
           caches filled from the encoder;
  whisper train  the train phase at full size with leafwise QSGD (104
           launches), the local step profiled, then the kernel on the
           24 x 1024 x 4096 FFN stack as train width;
  internvl prefill / serve  internvl2-26b at full width and 12 of its 48
           layers on B = 2 x (256 stub patches + 3840 tokens): the
           prefill phase (12 flash launches at H = 48, Kv = 8, D = 128;
           flash against dense), then the serve phase on tokens;
  internvl train  the train phase at 3 layers with leafwise natural (44
           launches), its loss held to the text positions, then the
           kernel on the (3, 6144, 16384) w_gate stack;
  mesh width  the multi-device launch layer as a world of one on NCCL:
           the width cell (8 clients x d = 411,060,224, the quadratic
           objective, xi [0, 1, 1, 0, 1]) through rollout_l2gd_sharded on
           a 1-process client mesh, packed QSGD then packed natural both
           ways, each run equal to rollout_l2gd's on the same state and
           trace bit for bit (every leaf's bits by an exact positional
           digest, the losses and xis compared whole); the all_gather's
           bytes against round_bits() / 8 x n a fresh round, one gather
           of the 8 payloads timed;
  mistral prefill / serve  mistral-large-123b at full width and 2 of its
           88 layers (3,170,955,264 parameters) as the prefill phase (2
           flash launches at H = 96, Kv = 8, D = 128; flash against
           dense), then the serve phase; flash width times its shape;
  mistral mesh2d train  mistral-large-123b at full width and 1 layer, 2
           clients x one 4096-token sequence, leafwise natural:
           build_sharded_rollout_fn on a (1, 1) train mesh with
           remat_policy="dots" against build_rollout_fn with "full", a
           step a call over a trace of cached, local and fresh steps,
           params and cache bit for bit (the digest), losses and xis
           equal; each branch's seconds and the peak, <= 70 GB;
  mesh2d shards  stablelm-1.6b at full width (SHARDS_LAYERS layers), 2
           clients x one 4096-token sequence, leafwise natural, a local
           then a fresh step: the 2-D engine's Megatron split on a (1, 2)
           train mesh of two processes sharing the card in one gloo group
           (each runs its block of every product; the aggregation a leaf
           piece at a time), against build_rollout_fn in this process:
           branches equal, losses and each rank's blocks of the params
           and cache within rtol 1e-5 / atol 1e-6 outside a Poisson
           bound of codec flips, the leaves the model axis leaves whole
           equal across the ranks, no leaf gathered in the local step;
           then the engine that gathers each layer whole
           (gather_layers; SHARDS_GATHER_LAYERS layers) bit for bit by
           the digest; each rank's peak below the one-process peak;
           seconds a branch, the gathers' and reduces' bytes;
  hymba split  hymba-1.5b at full width and HYMBA_SPLIT_LAYERS layers
           through the split on the same mesh, against the same
           references: the scan kernel and its backward on each rank's
           800 of 1600 channels, the MLP split, the attention (25 heads)
           gathered; then both scan kernels at that shape against their
           plain versions and bounds.

Each group of phases logs its seconds ("lap ..."), the total the sum.

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
# the threefry array draws' kernel (one launch a draw): its library's
# entry point, the INT32-pipe operations a counter in its block (20
# rotations and 21 xors; its 32 adds go to the FMA pipe as IMAD), the
# profiler's marks of an int64 elementwise pass, and
# the width check: stablelm-1.6b's w_gate stack a client (2 keys x
# 276,824,064 counters) at offset 0 and past 2^32, where the draw's
# counters cross into the next high word after 2^27 of them
DRAW_KERNEL = "threefry_draw"
THREEFRY_SOURCE = "src/repro_torch/kernels/threefry/csrc/threefry.cu"
THREEFRY_OPS = 41
INT64_NAMES = ("<long", "long>", "int64")
THREEFRY_SHAPE = (24, 2048, 5632)
THREEFRY_OFFSETS = (0, 3 * 2 ** 32 - 2 ** 27)
THREEFRY_P = 0.3
THREEFRY_PROFILED = 8
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
# phases train (Mamba): hymba-1.5b at full width and 16 of its 32 layers
# (32 until the split's phases joined the script: the cut keeps it inside
# its time limit); falcon-mamba-7b at full width and 4 of its 64 layers
# (two clients' f32 params, cache and gradients at 64 layers exceed the
# card's 80 GB; 4, not 8, keeps the script inside its time limit)
MAMBA_TRAIN = (("hymba-1.5b", 16, "natural"),
               ("falcon-mamba-7b", 4, "qsgd"))
TRAIN_PARAMS = {("stablelm-1.6b", None): STABLELM_PARAMS,
                ("hymba-1.5b", 16): 701_724_800,
                ("falcon-mamba-7b", 4): 687_591_424,
                ("granite-moe-1b-a400m", None): 1_334_628_352,
                ("deepseek-v2-lite-16b", 3): 1_460_420_096,
                ("whisper-medium", None): 959_204_352,
                ("internvl2-26b", 3): 1_738_899_456}
# phase model grad: 2-layer hymba-1.5b at full width, one sequence of 512
# tokens, the card's gradient (the scan kernels) against the CPU's (the
# chunked scan under autograd) from the same params: max |d| over max
# |cpu| of each leaf.  The bound is a choice, set before the first run:
# the two sum the matrix products (K up to 5504) in other orders and the
# scans round differently (2.4e-7 of y, tests/test_torch_mamba.py), and
# the reduced models' gradients hold 2e-5 against jax.grad on the CPU
MODEL_GRAD_LAYERS, MODEL_GRAD_S = 2, 512
MODEL_GRAD_RTOL = 1e-4
# phases moe prefill / serve: the MoE and MLA family at full width, each
# (arch, layers) with its parameter count: granite-moe-1b-a400m at full
# depth; moonshot-v1-16b-a3b (48 layers: 114 GB) and deepseek-v2-lite-16b
# (27 layers: 62 GB) at 12 layers, their first 12 (deepseek's dense first
# layer and 11 MoE layers)
MOE_SERVE = {("granite-moe-1b-a400m", None): 1_334_628_352,
             ("moonshot-v1-16b-a3b", 12): 7_389_890_560,
             ("deepseek-v2-lite-16b", 12): 6_724_050_944}
# flash against dense logits of a MoE model, x max |logit|.  Set after
# the first run on the card measured 2.8e-5 x at granite's 24 layers,
# with the routes forced equal (stablelm's 1e-5 holds 24 dense layers):
# every layer's gates move with their inputs, so the attention's 2e-6
# differences grow layer by layer; the kernel itself is held to FLASH_TOL
# on the last layer's own operands
MOE_LOGIT_RTOL = 1e-4
# a route that an ulp flips between two runs of the same function (flash
# against dense attention, decode against forward, the card against the
# CPU) is counted; flips are near-ties, so their count over P (token,
# slot) pairs is held to a Poisson bound, mean ROUTE_FLIP_RATE x P plus
# five of its standard deviations (flip_bound).  The rate is 3.7 x the
# pooled reading of six comparisons on the H100 (120 of 2,231,232 pairs:
# granite flash vs dense 74 of 1,572,864, moonshot 42 of 589,824, granite
# decode vs forward 4 of 30,336, moonshot 0 of 11,376, deepseek 0 of
# 10,428, moe grad 0 of 16,384; the largest single share 1.3e-4, on 4
# flips), set before granite's flash vs dense at seeds 1-4 read 88-112
# flips each.  Routes that differ for a cause other than an ulp flip a
# large share (a wrong order: 94%)
ROUTE_FLIP_RATE = 2e-4
# phase route seeds: granite's flash-against-dense flips at more seeds of
# its weights (phase moe prefill reads seed 0)
ROUTE_ARCH, ROUTE_SEEDS = "granite-moe-1b-a400m", (1, 2, 3, 4)
# phases train (MoE): granite-moe-1b-a400m at full width and depth with
# each codec, deepseek-v2-lite-16b at its first 3 layers (the dense one
# and 2 MoE layers: two clients at 27 layers exceed the card); the last
# field: profile a local and a fresh step (granite's natural run only:
# the profiler's pass over a fresh step's 120,000 kernels takes ~40 s)
MOE_TRAIN = (("granite-moe-1b-a400m", None, "natural", True),
             ("granite-moe-1b-a400m", None, "qsgd", False),
             ("deepseek-v2-lite-16b", 3, "qsgd", False))
# phase moe grad: a 2-layer granite-moe-1b-a400m at full width on one
# sequence of MODEL_GRAD_S tokens, the bound of phase model grad
MOE_GRAD_ARCH = "granite-moe-1b-a400m"
# phase fleet width: the width cell's 8 clients in benchmarks/
# bench_fleet.py's three cohorts (client i in cohort i mod 3)
FLEET_ASSIGNMENT = tuple(i % 3 for i in range(8))
# phase flash width: (arch, B, S, H, Kv, D) of each prefill the kernel
# runs at a model's size: stablelm's (the kernel's row), granite's GQA,
# moonshot's D = 128
FLASH_SHAPES = (("stablelm-1.6b", PREFILL_B, PREFILL_S, 32, 32, 64),
                ("granite-moe-1b-a400m", PREFILL_B, PREFILL_S, 16, 8, 64),
                ("moonshot-v1-16b-a3b", PREFILL_B, PREFILL_S, 16, 16, 128),
                ("internvl2-26b", PREFILL_B, PREFILL_S, 48, 8, 128),
                ("mistral-large-123b", PREFILL_B, PREFILL_S, 96, 8, 128))
# phases whisper and internvl: whisper-medium at full size; internvl2-26b
# at full width and 12 of its 48 layers for serving (77.2 GB of f32 params
# at 48), 3 for training (two clients' params, cache and gradients); each
# (arch, layers) prefilled with its parameter count
PREFILL_PARAMS = {("stablelm-1.6b", None): STABLELM_PARAMS,
                  ("internvl2-26b", 12): 5_249_642_496,
                  ("mistral-large-123b", 2): 3_170_955_264}
WHISPER, WHISPER_PARAMS = "whisper-medium", 959_204_352
INTERNVL_SERVE = ("internvl2-26b", 12)
# phases mistral: mistral-large-123b (122,207,416,320 parameters: 489 GB
# of f32) at full width, 2 of its 88 layers served, 1 trained (two
# clients' params, cache and gradients: 36 GB)
MISTRAL_SERVE = ("mistral-large-123b", 2)
MISTRAL_TRAIN_PARAMS = 1_786_810_368
# phase mistral mesh2d train: a step a call (chunking is invisible to the
# protocol's streams), the key's trace over these steps: cached, local,
# fresh, cached
MESH2D_XI = [1, 0, 1, 1]
# phase mesh2d shards: stablelm-1.6b's layers under the split (4 of 24)
# and under the gather engine (2: gloo moves ~0.7 GB/s a rank; the
# gather at 24 layers took 163.5 s, at 4 69.2), hymba-1.5b's under the
# split (2 of 32), the trace (local, fresh), the model shards (two
# processes on the one card, gloo); (phase, arch, layers, gather_layers)
SHARDS_LAYERS, SHARDS_GATHER_LAYERS, HYMBA_SPLIT_LAYERS = 4, 2, 2
SHARDS_RUNS = (("mesh2d shards", "stablelm-1.6b", SHARDS_LAYERS, False),
               ("mesh2d shards (gather)", "stablelm-1.6b",
                SHARDS_GATHER_LAYERS, True),
               ("hymba split", "hymba-1.5b", HYMBA_SPLIT_LAYERS, False))
SHARDS_XI = [0, 1]
SHARDS_RANKS = 2
# the split against one process: the reference's tolerance
# (tests/test_mesh2d.py:349), and the chance that natural rounds a
# compressed element the other way when its input moved by the split's
# ulp-level differences (about the input's relative difference, under
# 1e-8 after one local step: the step moves a weight by ~1e-3 of
# itself, its gradient differs by ~1e-6 of itself; 1e-6 is a margin of
# 100)
SHARDS_RTOL, SHARDS_ATOL = 1e-5, 1e-6
SHARDS_FLIP_RATE = 1e-6
# phase mesh width: the digest's positional multiplier (odd: a single
# changed element always changes the sum mod 2^64) and its chunk
DIGEST_MUL, DIGEST_CHUNK = -7046029254386353131, 1 << 26
# (arch, layers, codec): whisper trains with one leafwise codec, internvl
# with the other
FRONTEND_TRAIN = (("whisper-medium", None, "qsgd"),
                  ("internvl2-26b", 3, "natural"))
# phase paper fedavg: benchmarks/bench_fig7_fedavg_recovery.py's sizes (5
# clients, L2GD 400 steps, FedAvg 200 rounds; the compressed FedAvg and
# FedOpt half as many) and a 3 x 3 (p, lambda) grid of 100-step rollouts
FIG7_N, FIG7_STEPS, FIG7_ROUNDS = 5, 400, 200
GRID_PS, GRID_LAMS, GRID_STEPS = (0.2, 0.5, 0.8), (0.5, 2.0, 10.0), 100
# phase fedavg lm: rounds of FedAvg and of FedOpt on stablelm-1.6b
FEDAVG_ROUNDS = 2
# phase async width: the chaos run's forced xi (5 fresh rounds) and the
# reduced tree of its card-against-CPU check (vocab, d_model, d_ff,
# layers): d = 5120 * 128 + 128 + 2 * (4 * 128^2 + 3 * 128 * 352 + 2 * 128)
CHAOS_XI = [0, 1] * 5
ASYNC_DIMS = (5120, 128, 352, 2)
ASYNC_D = 1_057_408


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
    from repro_torch import tracing
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
        with Recorded() as spans, tracing.recording():
            cpu, cpu_loss, _ = paper_run("cpu", comp, plans, LEAFWISE_STEPS)
        same_protocol(gpu, cpu, f"leafwise {name}")
        # one leaf, two links: two launches a fresh round; one launch of
        # the threefry kernel for each draw the same run makes on the CPU
        want = {} if name not in LEAFWISE_KERNELS else \
            {LEAFWISE_KERNELS[name]: 2 * gpu.n_agg_comm}
        draws = sum(1 for sp in spans.spans if sp.name == "draw")
        if draws:
            want[DRAW_KERNEL] = draws
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

def width_tree(n, make, dims=None):
    """The stacked parameter tree, every leaf from ``make(shape)``; ``dims``
    (vocab, d_model, d_ff, layers) default to stablelm-1.6b's at 4
    layers."""
    V, D, F, L = dims or (VOCAB, D_MODEL, D_FF, LAYERS)
    return {
        "embed": {"table": make((n, V, D))},
        "final_norm": {"scale": make((n, D))},
        "layers": {
            "attn": {k: make((n, L, D, D)) for k in ("wq", "wk", "wv", "wo")},
            "ffn": {"w_gate": make((n, L, D, F)), "w_up": make((n, L, D, F)),
                    "w_down": make((n, L, F, D))},
            "ln1": {"scale": make((n, L, D))},
            "ln2": {"scale": make((n, L, D))},
        },
    }


def width_objective(dev, n, dims=None, host_seeds=False):
    """(seeded leaf maker, targets tree, grad_fn) of the width phases:
    f_i(w) = 0.5 ||w - a_i||^2 over every leaf (the quadratic fixture of
    tests/conftest.py), targets a_i ~ N(0, 1) from seed 1; ``dims`` as in
    width_tree.  ``host_seeds`` draws on the CPU and moves the values to
    ``dev``, so that a card run and a CPU run start from the same ones."""
    import torch
    from repro_torch.core.tree import tree_map
    gen = torch.Generator(device="cpu" if host_seeds else dev)

    def seeded(seed, scale):
        gen.manual_seed(seed)
        if host_seeds:
            return lambda shape: torch.randn(shape, generator=gen) \
                .mul_(scale).to(dev)
        return lambda shape: torch.randn(shape, generator=gen, device=dev) \
            .mul_(scale)

    targets = width_tree(n, seeded(1, 1.0), dims)

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


def prefill_tokens(dev, cfg, seq=PREFILL_S):
    """PREFILL_B sequences of ``seq`` tokens of the token stream."""
    import torch
    from repro_torch.data import TokenStream
    return torch.from_numpy(TokenStream(
        n_clients=1, vocab=cfg.vocab_size, batch=PREFILL_B,
        seq=seq).batch_at(0)[0]).long().to(dev)


def phase_prefill(dev, arch="stablelm-1.6b", layers=None):
    """``arch`` (a GQA decoder) at full width and ``layers`` of its layers
    (all by default) on PREFILL_B sequences of PREFILL_S positions: the
    prefill step and forward with attn_impl="flash" (a kernel launch a
    layer), forward with dense attention, held against each other.  A
    vision config's PREFILL_S positions are its stub patches and
    PREFILL_S - P tokens.  Returns (cfg, params, the tokens, the step's
    launches)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.kernels.dispatch import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import forward, init_params, param_count
    from repro_torch.models.frontends import stub_patch_embeddings

    cfg = dataclasses.replace(get_config(arch), attn_impl="flash")
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    params, init_s = timed(lambda: init_params(
        torch.Generator(device=dev).manual_seed(0), cfg))
    check(param_count(params) == PREFILL_PARAMS[(arch, layers)],
          f"{arch} parameter count")
    vision = cfg.frontend == "vision"
    P = cfg.n_frontend_tokens if vision else 0
    tokens = prefill_tokens(dev, cfg, PREFILL_S - P)
    batch = {"tokens": tokens}
    if vision:
        batch["patches"] = stub_patch_embeddings(prng.PRNGKey(0), cfg,
                                                 PREFILL_B, device=dev)
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
    log(profile_line(f"{arch} prefill step", *device_profile(
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
    log(f"phase prefill: {arch}, {cfg.n_layers} layers, "
        f"{param_count(params):,} params (init {init_s:.2f} s); B={PREFILL_B}"
        f" S={PREFILL_S}" + (f" ({P} patches + {PREFILL_S - P} tokens)"
                             if vision else "") +
        f": prefill step {first_s:.3f} s first, "
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


def phase_whisper_prefill(dev):
    """whisper-medium at full size on PREFILL_B sequences of PREFILL_S
    tokens and their stub frames: the prefill step (dense attention, as
    the reference's: no kernel) timed and profiled, held against
    forward's last position; the frames' normal draw on the card against
    the host's.  Returns (cfg, params, tokens, frames)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.kernels.dispatch import LAUNCHES, reset_launches
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import forward, init_params, param_count
    from repro_torch.models.frontends import stub_frame_embeddings

    cfg = get_config(WHISPER)
    params, init_s = timed(lambda: init_params(
        torch.Generator(device=dev).manual_seed(0), cfg))
    check(param_count(params) == WHISPER_PARAMS, "whisper parameter count")
    tokens = prefill_tokens(dev, cfg)
    key = prng.PRNGKey(0)
    frames = stub_frame_embeddings(key, cfg, PREFILL_B, device=dev)
    shape = (PREFILL_B, cfg.n_frontend_tokens, cfg.d_model)
    # each draw is within NORMAL_ULPS of jax.random.normal (CPU tests)
    draw_ulps = ulps(prng.tensor_normal(key, shape, dev),
                     torch.from_numpy(prng.normal(key, shape)).to(dev))
    check(draw_ulps <= 2 * prng.NORMAL_ULPS,
          f"normal draw on the card vs the host: {draw_ulps:g} ulps")
    batch = {"tokens": tokens, "frames": frames}
    prefill = build_prefill_step(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()            # the prefill main path starts here
    last, first_s = timed(lambda: prefill(params, batch))
    check(not LAUNCHES, f"whisper prefill launched {dict(LAUNCHES)}")
    check(last.shape == (PREFILL_B, cfg.vocab_size)
          and bool(torch.isfinite(last).all()), "whisper prefill logits")
    _, prefill_s = timed(lambda: prefill(params, batch))
    log(profile_line(f"{WHISPER} prefill step", *device_profile(
        lambda: prefill(params, batch))))
    with torch.no_grad():
        full, forward_s = timed(lambda: forward(params, cfg, batch)[0])
    peak = torch.cuda.max_memory_allocated(dev)
    check(bool(torch.isfinite(full).all()), "non-finite whisper logits")
    step_err = float(torch.max(torch.abs(full[:, -1] - last)))
    check(step_err <= 1e-5 * float(last.abs().max()),
          f"whisper prefill step vs forward's last position: {step_err:.3g}")
    other = dict(batch, frames=frames.flip(1))
    check(not torch.equal(prefill(params, other), last),
          "the frames do not reach the logits")
    del full
    log(f"phase whisper prefill: {WHISPER}, {cfg.n_layers} decoder + "
        f"{cfg.encoder_layers} encoder layers, {param_count(params):,} params"
        f" (init {init_s:.2f} s); B={PREFILL_B} S={PREFILL_S} tokens + "
        f"{cfg.n_frontend_tokens} frames: prefill step {first_s:.3f} s first,"
        f" {prefill_s:.3f} s second; forward {forward_s:.3f} s (peak "
        f"{peak / 1e9:.2f} GB); step vs forward max |d| {step_err:.3g}; "
        f"frames' normal draw card vs host within {draw_ulps:g} ulps")
    return cfg, params, tokens, frames


def fill_cross(params, cfg, caches, frames):
    """The encoder-decoder's cross caches from the encoder's output on
    ``frames``, as the reference's test fills them (its init_caches
    makes zeros and no reference code fills them)."""
    import torch
    from repro_torch.models import encoder_forward
    with torch.no_grad():
        enc = encoder_forward(params, cfg, frames)
        B, H, D = enc.shape[0], cfg.n_heads, cfg.hd
        for c, wk, wv in zip(caches, params["cross"]["attn"]["wk"],
                             params["cross"]["attn"]["wv"]):
            c["cross_k"] = (enc @ wk).reshape(B, -1, H, D)
            c["cross_v"] = (enc @ wv).reshape(B, -1, H, D)
    return caches


def phase_serve(dev, cfg, params, tokens, moe=False, frames=None):
    """Teacher-forced prompt and greedy tokens through the caches, held
    against forward.  ``moe``: decode's routes are recorded on the device
    in the timed loop (no sync), the MoE spans join the decode profile,
    and forward runs twice: on its own routes, held against decode on
    the tokens whose routes agree (the flips counted), then taking
    decode's routes, held on every token.  ``frames`` (the
    encoder-decoder's): the cross caches are filled from the encoder on
    them before the loop (not timed), and forward takes them."""
    import contextlib
    import torch
    from repro_torch.kernels.dispatch import LAUNCHES, reset_launches
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models import forward, init_caches

    prompt = tokens[:, :PROMPT]
    serve = build_serve_step(cfg)
    caches = init_caches(cfg, PREFILL_B, PROMPT + GENERATE, device=dev)
    extra_batch = {}
    if frames is not None:
        caches = fill_cross(params, cfg, caches, frames)
        extra_batch["frames"] = frames
    routes = Routes() if moe else contextlib.nullcontext()
    with routes:
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
    with Recorded() as spans:
        wall, by_kind, count = device_profile(lambda: serve(
            params, caches, PROMPT + GENERATE - 1,
            {"tokens": generated[-1][:, None]}))
    log(profile_line(f"{cfg.name} decode step", wall, by_kind, count)
        + (f"; {spans.moe_shares(wall)}" if moe else ""))
    generated = torch.stack(generated, 1)
    decoded = torch.stack(prompt_logits + gen_logits, 1)
    batch = {"tokens": torch.cat([prompt, generated[:, :-1]], 1),
             **extra_batch}
    extra = ""
    forced = contextlib.nullcontext()
    if moe:
        n_moe = cfg.n_layers - cfg.first_dense_layers
        with torch.no_grad(), Routes() as own:
            full, _ = forward(params, cfg, batch)
        flips, clean = route_agreement(routes, own, n_moe)
        err, agree = clean_err(decoded, full, clean)
        check(err <= DECODE_TOL, f"{cfg.name} decode vs forward on the "
              f"{agree} tokens whose routes agree: {err:.3g}")
        extra = (f"; capacity factor {cfg.capacity_factor:g} (nothing "
                 f"drops: {own.dropped} of {own.assigned} dropped); "
                 f"forward on its own routes: {flips}, the {agree} of "
                 f"{clean.numel()} tokens before a sequence's first "
                 f"differing route within {err:.3g}")
        check(own.dropped == 0, f"{cfg.name}: forward dropped "
              f"{own.dropped} assignments at the no-drop capacity")
        del full
        forced = Routes(force=[t for t, _ in routes.by_layer(n_moe)])
    with torch.no_grad(), forced:
        full, _ = forward(params, cfg, batch)
    if moe:
        extra += "; forward on decode's routes: " + forced.check_flips(
            f"{cfg.name} decode vs forward (forced)")
    if cfg.mixer == "mla":
        c_kv, k_rope = caches[0]
        floats = c_kv.shape[-1] + k_rope.shape[-1]
        extra += (f"; latent cache {floats} floats = "
                  f"{floats * c_kv.element_size()} bytes a token and layer")
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
        f"tokens {generated[0, :8].tolist()}...{extra}")


# --------------------------------------------------------------------------
# flash at the prefill shapes and at 32k: time, bound, plain, library
# --------------------------------------------------------------------------

def flash_bound_ms(B, H, S, D, Kv=None):
    """Causal (S = T), f32 inputs: (pairs, route ms, CUDA-core ms, bytes
    ms).  The kernel's route: 3 split-TF32 passes of 4 D flops per visible
    pair on the tensor cores, or one exp a pair on the special-function
    units if that is larger.  Beside it the CUDA-core float32 bound (4 D
    flops a pair at 67 TFLOP/s), which only a design on the CUDA cores is
    held to; and q, k, v (Kv heads) and the output read / written once."""
    Kv = H if Kv is None else Kv
    pairs = B * H * S * (S + 1) // 2
    tf32_ms = FLASH_PASSES * 4 * D * pairs / PEAK_TF32_OPS_PER_S * 1e3
    exp_ms = pairs / PEAK_SFU_OPS_PER_S * 1e3
    f32_ms = 4 * D * pairs / PEAK_F32_OPS_PER_S * 1e3
    bytes_ms = (2 * H + 2 * Kv) * B * S * D * 4 / PEAK_BYTES_PER_S * 1e3
    return pairs, max(tf32_ms, exp_ms), f32_ms, bytes_ms


def flash_shape(dev, gen, arch, B, S, H, Kv, D):
    """The kernel at one prefill shape (causal f32): checked against its
    plain version and timed against its route bound, the plain version
    and scaled_dot_product_attention (given K / V repeated to H heads
    outside the timed call).  Returns (max |kernel - plain|, ms, plain
    ms, library ms, bound ms, bound_by)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ops import flash_attention_op

    q = torch.randn((B, S, H, D), generator=gen, device=dev)
    k, v = (torch.randn((B, S, Kv, D), generator=gen, device=dev)
            for _ in range(2))
    out = flash_attention_op(q, k, v)
    plain = fk._plain(q, k, v, True, None)
    err = float(torch.max(torch.abs(out - plain)))
    check(err <= FLASH_TOL, f"flash at {arch}'s prefill shape: {err:.3g}")
    del plain
    ms = time_ms(lambda: flash_attention_op(q, k, v), reps=10)
    plain_ms = time_ms(lambda: fk._plain(q, k, v, True, None), reps=3,
                       warmup=1)
    qt = q.transpose(1, 2)
    kt, vt = (torch.repeat_interleave(t, H // Kv, dim=2).transpose(1, 2)
              for t in (k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), reps=10)
    lib_err = float(torch.max(torch.abs(F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True).transpose(1, 2) - out)))
    pairs, ops_ms, f32_ms, bytes_ms = flash_bound_ms(B, H, S, D, Kv)
    del q, k, v, qt, kt, vt, out
    torch.cuda.empty_cache()
    log(f"time flash_attention at {arch}'s prefill shape (B={B} S=T={S} "
        f"H={H} Kv={Kv} D={D} causal f32): {ms:.3f} ms (route bound "
        f"{ops_ms:.3f} ms: {pairs:,} pairs, {FLASH_PASSES} x "
        f"{4 * D * pairs / 1e9:.1f} GFLOP of TF32 or {pairs:.3g} exps; "
        f"bytes {bytes_ms:.3f} ms; {ops_ms / ms:.0%} of it; CUDA-core f32 "
        f"bound {f32_ms:.3f} ms, the kernel at {ms / f32_ms:.2f}x it); plain "
        f"version {plain_ms:.1f} ms; scaled_dot_product_attention "
        f"{library_ms:.3f} ms (the kernel at {ms / library_ms:.2f}x it; max "
        f"|d| {lib_err:.3g} from the kernel); kernel vs plain max |d| "
        f"{err:.3g}")
    return (err, ms, plain_ms, library_ms, max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes")


def phase_flash_width(dev, launches):
    """The kernel at FLASH_SHAPES (its row: stablelm-1.6b's), then at
    the prefill_32k length."""
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    gen = torch.Generator(device=dev).manual_seed(3)
    results = [flash_shape(dev, gen, *shape) for shape in FLASH_SHAPES]
    err, ms, plain_ms, library_ms, bound_ms, bound_by = results[0]
    row = {"name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
           "replaces": FLASH_REPLACES,
           "launches": launches.get("flash_attention", 0),
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms}

    # prefill_32k: one sequence of 32768 tokens at stablelm's heads
    H, D = FLASH_SHAPES[0][3], FLASH_SHAPES[0][5]
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
    shape of hymba-1.5b, whose train run at 16 layers gave
    ``launches``)."""
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
    "elementwise": device ms}, kernel count, threefry kernels).  "gemm"
    is every matrix product (the attention's included), "attention" its
    softmax, "kernel" the codecs' hand-written kernels, "scan" and
    "scan_bwd" the selective scan's forward and backward kernels, "draw"
    the threefry draw kernel (every array draw's one launch); the
    elementwise kernels are the rest.  The device ms do not overlap."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kind = {"gemm": 0.0, "attention": 0.0, "draw": 0.0, "kernel": 0.0,
               "scan": 0.0, "scan_bwd": 0.0, "elementwise": 0.0}
    count = draws = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.key.lower()
        if "threefry_kernel" in name:
            draws += e.count
        kind = "draw" if "threefry_kernel" in name else \
            "kernel" if ("qsgd_dequantized" in name
                         or "natural_noise" in name) else \
            "scan_bwd" if ("scan_bwd_" in name
                           or "sum_middle" in name) else \
            "scan" if "scan_kernel<" in name else \
            "gemm" if "gemm" in name or "gemv" in name else \
            "attention" if "softmax" in name else "elementwise"
        by_kind[kind] += e.self_device_time_total / 1e3
        count += e.count
    return wall_ms, by_kind, count, draws


def no_plain_draw(*args, **kwargs):
    """Stands in for ``prng._draw_plain`` while a run on the card must draw
    through the threefry kernel alone."""
    raise AssertionError("a draw on the card reached the plain int64 "
                         "version")


def train_line(what, wall_ms, by_kind, count):
    busy = sum(by_kind.values())
    if not count:
        return f"profile {what}: the profiler saw no device activity"
    return (f"profile {what}: wall {wall_ms:.1f} ms, {count} kernels, device "
            f"busy {busy:.1f} ms (idle share {1 - busy / wall_ms:.1%}): " +
            ", ".join(f"{k} {v:.1f} ms ({v / wall_ms:.1%})"
                      for k, v in by_kind.items()
                      if v or k not in ("scan", "scan_bwd")))


def phase_train(dev, name, arch="stablelm-1.6b", layers=None, profile=True):
    """``arch`` at full width (and ``layers`` of its layers, all by
    default), 2 clients x one 4096-token sequence, f32, remat on, dense
    attention: build_train_step with leafwise ``name`` compression both
    ways, forced xi TRAIN_XI.  Every leaf's codec runs the kernel: 2 fresh
    rounds x leaves x 2 links launches (44 for stablelm-1.6b).  A Mamba
    or hybrid model also runs the scan: its forward once a layer and
    client for each step's loss and again in each local step's recompute
    (remat), its backward once a layer and client in each local step; no
    other kernel runs.  The batches are the train CLI's (``launch.train.
    batch_fn``): a vision config's TRAIN_S positions are its stub patches
    and TRAIN_S - P tokens, and its loss is checked to leave the patch
    positions out; the encoder-decoder's carry stub frames.  Then one
    local and one fresh aggregation step under the profiler (``profile``
    True; "local": the local step only).  Returns the trained stacked
    params and the launch counts."""
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
    from repro_torch.launch.train import batch_fn, init_stacked_params
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
    P = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    stream = TokenStream(n_clients=n, vocab=cfg.vocab_size, batch=TRAIN_B,
                         seq=TRAIN_S - P)
    batch_at = batch_fn(cfg, stream, 0, dev)
    batches = [{key: torch.as_tensor(val).to(dev)
                for key, val in batch_at(k).items()}
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
    plain_draw = prng._draw_plain
    prng._draw_plain = no_plain_draw    # a draw on the card never gets there
    reset_launches()            # the train main path starts here
    times, losses, branches = [], [], []
    try:
        for k, xi in enumerate(TRAIN_XI):
            (state, metrics), seconds = timed(
                lambda: step(state, batches[k], xi, keys[k]))
            times.append(seconds)
            losses.append(float(metrics["loss"]))
            branches.append(metrics["branch"])
            if metrics["branch"] == 1:
                ledger.record_round(bits, bits, step=k)
    finally:
        prng._draw_plain = plain_draw
    launches = dict(LAUNCHES)   # and ends here
    peak = torch.cuda.max_memory_allocated(dev)
    kernel = LEAFWISE_KERNELS[name]
    check(branches == [0, 1, 2, 0, 1], f"branches {branches}")
    want = {kernel: 2 * 2 * leaves, DRAW_KERNEL: 2 * 2 * leaves}
    if cfg.mixer in ("mamba", "hybrid"):    # a scan in every layer
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
    extra = ""
    if P:
        extra = "; " + vision_loss_check(cfg, state.params, batches[0], P)
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
        f"launches {launches}{extra}")
    moe = cfg.ffn == "moe"
    if moe:
        check(local_steps_identical(step, state, batches[5], keys[5]),
              f"train {arch} ({name}): two local steps from one state "
              "differ")
        log(f"train {arch} ({name}): two local steps from one state "
            "bit-identical")
    for what, k in (("local step", 5), ("fresh aggregation step", 6)):
        if not profile or (profile == "local" and k == 6):
            break
        out = []
        with Recorded() as spans:
            wall, by_kind, count, draws = train_profile(
                lambda: out.append(step(state, batches[k], xis[k], keys[k])))
        spans_drawn = sum(1 for sp in spans.spans if sp.name == "draw")
        check(draws == spans_drawn == (2 * leaves if k == 6 else 0),
              f"train {arch} ({name}) {what}: {draws} threefry kernels for "
              f"{spans_drawn} draws")
        log(train_line(f"train {arch} ({name}) {what}", wall, by_kind, count)
            + (f"; {draws} threefry kernels, one a draw" if draws else "")
            + (f"; {spans.moe_shares(wall)}" if moe else ""))
        state = out[0][0]
    return state.params, launches


def vision_loss_check(cfg, stacked, batch, P):
    """Client 0's loss against the cross-entropy of its text logits
    alone (the logits after the P patch positions), bit for bit; a loss
    over the patch positions differs."""
    import torch
    from repro_torch.core.tree import tree_map
    from repro_torch.models import blocks, forward, loss_fn
    params = tree_map(lambda a: a[0], stacked)
    one = {key: val[0] for key, val in batch.items()}
    with torch.no_grad():
        loss = loss_fn(params, cfg, one)[0]
        logits = forward(params, cfg, one)[0]
        text = blocks.cross_entropy_loss(logits[:, P:-1], one["tokens"][:, 1:])
        shifted = blocks.cross_entropy_loss(logits[:, :-1][:, :P],
                                            one["tokens"][:, 1:P + 1])
    check(torch.equal(loss, text), f"{cfg.name}: loss {float(loss)} is not "
          f"the text positions' {float(text)}")
    check(not torch.equal(loss, shifted), f"{cfg.name}: loss equals the "
          "patch positions'")
    return (f"loss {float(loss):.6f} = the {one['tokens'].shape[1] - 1} text"
            f" positions' cross-entropy (the {P} patch positions' "
            f"{float(shifted):.6f})")


def phase_train_width(dev, arch, params, launches, name, norm_ulps):
    """The phase's kernel on the run's largest leaf, w_gate (stablelm-
    1.6b: 2 x 276,824,064 elements; granite-moe-1b-a400m's expert stack:
    2 x 402,653,184; deepseek-v2-lite-16b's at 3 layers: 2 x
    369,098,752), against its plain version and its bound, with the draw
    that feeds it (one threefry kernel launch) timed."""
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
    draw_ms = time_ms(lambda: prng.tensor_uniform(keys, shape, dev), reps=5)
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
        f"run of {arch}): {ms:.3f} ms (bound {max(bytes_ms, ops_ms):.3f} ms, "
        f"{nbytes / 1e9:.3f} GB; {bytes_ms / ms:.0%} of the memory "
        f"roofline); plain version {plain_ms:.1f} ms; its threefry noise "
        f"draw {draw_ms:.3f} ms" +
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


def phase_threefry_width(dev, launches):
    """The threefry draw kernel at stablelm-1.6b's w_gate draw (2 keys x
    276,824,064 counters) against its plain version, the int64 passes of
    ``prng._draw_plain``, on the card: bit for bit in each finish at each
    of THREEFRY_OFFSETS, one launch a draw; then each finish timed (CUDA
    events, median of 10 draws) beside its bound, the larger of
    THREEFRY_OPS INT32-pipe operations a counter at PEAK_I32_OPS_PER_S and
    its output's bytes at PEAK_BYTES_PER_S, and the plain version timed
    in the uniform finish; THREEFRY_PROFILED uniform draws under the
    profiler: their device operations are threefry kernels and the keys'
    copies, none of them int64 elementwise.  ``launches``: the
    train run's.  Returns the kernel's row."""
    import collections
    import math
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import prng
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.kernels.threefry.kernel import FINISHES

    keys = prng.split(prng.PRNGKey(9), TRAIN_CLIENTS)
    total = math.prod(THREEFRY_SHAPE)
    counters = TRAIN_CLIENTS * total
    p = float(np.float32(THREEFRY_P))
    for offset in THREEFRY_OFFSETS:
        for finish, (_, dtype) in FINISHES.items():
            before = LAUNCHES[DRAW_KERNEL]
            got = prng._draw(keys, THREEFRY_SHAPE, dev, finish, offset, p)
            check(LAUNCHES[DRAW_KERNEL] == before + 1,
                  f"threefry {finish}: {LAUNCHES[DRAW_KERNEL] - before} "
                  "launches for one draw")
            want = torch.empty((TRAIN_CLIENTS, total), dtype=dtype,
                               device=dev)
            prng._draw_plain(keys, want, offset, finish, p)
            check(torch.equal(got.reshape(want.shape), want),
                  f"threefry {finish} at offset {offset}: kernel and plain "
                  "version differ")
            del got, want
    torch.cuda.empty_cache()
    ms, bound = {}, {}
    for finish, (_, dtype) in FINISHES.items():
        ms[finish] = time_ms(lambda: prng._draw(
            keys, THREEFRY_SHAPE, dev, finish, 0, p), reps=10)
        nbytes = counters * torch.empty((), dtype=dtype).element_size()
        bound[finish] = max(
            THREEFRY_OPS * counters / PEAK_I32_OPS_PER_S,
            nbytes / PEAK_BYTES_PER_S) * 1e3
        torch.cuda.empty_cache()
    out = torch.empty((TRAIN_CLIENTS, total), device=dev)
    plain_ms = time_ms(lambda: prng._draw_plain(keys, out, 0, "uniform"),
                       reps=1, warmup=1)
    del out
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(THREEFRY_PROFILED):
            prng.tensor_uniform(keys, THREEFRY_SHAPE, dev)
        torch.cuda.synchronize()
    ops = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    # the profiler can drop the events of the first draw it sees: the
    # launches are counted above; here, what a draw runs on the card
    check(any("threefry_kernel" in o for o in ops)
          and all("threefry_kernel" in o or "Memcpy" in o for o in ops)
          and not any(m in o for o in ops for m in INT64_NAMES),
          f"{THREEFRY_PROFILED} draws' device operations: "
          f"{collections.Counter(ops)}")
    torch.cuda.empty_cache()
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    log(f"phase threefry width: {TRAIN_CLIENTS} keys x {total:,} counters "
        f"(stablelm-1.6b's w_gate stack a client), bits / uniform / "
        f"bernoulli bit-exact to the plain int64 version at offsets "
        f"{THREEFRY_OFFSETS}, one launch a draw; " +
        "; ".join(f"{f} {ms[f]:.3f} ms (bound {bound[f]:.3f} ms, "
                  f"{bound[f] / ms[f]:.0%})" for f in FINISHES) +
        f"; plain version (uniform) {plain_ms:.1f} ms; "
        f"{counters / ms['uniform'] / 1e6:.3g}e9 counters a second; "
        f"{THREEFRY_PROFILED} draws' device operations "
        f"{dict(collections.Counter(ops))}; SM clock now / max {clocks}")
    return {"name": DRAW_KERNEL, "route": "cuda", "source": THREEFRY_SOURCE,
            "replaces": None, "launches": launches.get(DRAW_KERNEL, 0),
            "max_abs_err": 0.0, "ms": ms["uniform"], "plain_ms": plain_ms,
            "bound_ms": bound["uniform"], "bound_by": "operations",
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


# --------------------------------------------------------------------------
# phase paper fedavg: Fig 7 (FedAvg as L2GD at agg_scale 1), FedOpt, the
# compressed-difference FedAvg, error feedback and the (p, lambda) grid on
# the logistic-regression fixture, the card against the port on the CPU
# --------------------------------------------------------------------------

def fig7_problem(device):
    """(X, Y, stacked grad_fn, one client's grad_fn, mean loss of a stacked
    w, mean loss of a global w) of benchmarks/bench_fig7_fedavg_recovery.py
    (logistic regression, 5 clients, d = 124, seed 0) on ``device``."""
    import torch
    from repro_torch.data import logreg_loss_and_grad, make_logreg_data

    data = make_logreg_data(n_clients=FIG7_N, seed=0)
    X = torch.from_numpy(data.features).to(device)
    Y = torch.from_numpy(data.labels).to(device)

    def grad_fn(p, b):
        loss, g = logreg_loss_and_grad(p["w"], b[0], b[1], 0.01)
        return loss, {"w": g}

    def mean_loss(w):
        return float(torch.mean(logreg_loss_and_grad(w, X, Y, 0.01)[0]))

    return X, Y, grad_fn, mean_loss


def paper_fedavg_runs(device):
    """Every run of the phase on ``device``: {name: (run, final loss)} and
    the grid's (states, traces, per-cell final losses)."""
    import torch
    from repro_torch.core import (L2GDHyper, hyper_grid, make_compressor,
                                  prng, rollout_l2gd_grid)
    from repro_torch.fl import run_fedavg, run_fedopt, run_l2gd

    X, Y, grad_fn, mean_loss = fig7_problem(device)
    n, p, eta = FIG7_N, 0.5, 0.5
    hp = L2GDHyper(eta=eta, lam=n * p / eta, p=p, n=n)
    check(abs(float(hp.agg_scale) - 1.0) < 1e-6, "agg_scale")
    out = {}
    run = run_l2gd(prng.PRNGKey(0), {"w": torch.zeros(n, 124)}, grad_fn, hp,
                   lambda k: (X, Y), FIG7_STEPS, device=device)
    out["l2gd"] = (run, mean_loss(run.state.params["w"]))
    batches = lambda r, i: [(X[i], Y[i])]
    lr = eta / (n * (1 - p))
    for name, fn, kw in (
            ("fedavg", run_fedavg, {}),
            ("fedavg qsgd", run_fedavg,
             {"compressor": make_compressor("qsgd")}),
            ("fedopt", run_fedopt, {"server_lr": 0.05})):
        rounds = FIG7_ROUNDS if name == "fedavg" else FIG7_ROUNDS // 2
        fed = fn(prng.PRNGKey(1), {"w": torch.zeros(124)}, grad_fn, batches,
                 n, rounds, local_lr=lr, device=device, **kw)
        out[name] = (fed, mean_loss(fed.params["w"][None]))
    rule = lambda P, L: np.minimum(0.4, n * P / L)
    hp_grid, _ = hyper_grid(GRID_PS, GRID_LAMS, rule, n)
    comp = make_compressor("natural")
    states, traces = rollout_l2gd_grid(
        prng.PRNGKey(2), {"w": torch.zeros(n, 124, device=device)}, hp_grid,
        (X, Y), grad_fn=grad_fn, steps=GRID_STEPS, client_comp=comp,
        master_comp=comp, batch_axis=None)
    losses = [mean_loss(w) for w in states.params["w"]]
    return out, (states, traces, losses)


def ef_quadratic(device, use_ef, steps=3000, tail=500):
    """tests/test_extensions.py's error-feedback check on ``device``: L2GD
    on the quadratic (8 clients, d = 32) with top-k 10% and (``use_ef``)
    the EF memory or without; the relative distance of the tail-averaged
    models from x*."""
    import torch
    from repro_torch.core import (L2GDHyper, aggregation_update,
                                  compressed_average, local_update,
                                  make_compressor, prng)
    from repro_torch.core.extensions import ef_average, init_ef_memory

    n, d = 8, 32
    A = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (n, d)).astype(np.float32)).to(device)
    hp = L2GDHyper(eta=0.3, lam=1.0, p=0.3, n=n)
    comp, ident = make_compressor("topk", fraction=0.1), \
        make_compressor("identity")
    xstar = (A + hp.lam * A.mean(0)) / (1 + hp.lam)
    rng = np.random.default_rng(0)
    params = {"w": torch.zeros(n, d, device=device)}
    mem = init_ef_memory(params)
    key = prng.PRNGKey(1)
    cache = {"w": torch.zeros(d, device=device)}
    avg, xi_prev = torch.zeros(n, d, device=device), 1
    for t in range(steps):
        key, sub = prng.split(key)
        xi = int(rng.random() < hp.p)
        if xi == 0:
            params = local_update(params, {"w": params["w"] - A}, hp)
        else:
            if xi_prev == 0:
                if use_ef:
                    cache, mem = ef_average(sub, params, mem, comp, ident)
                else:
                    cache = compressed_average(sub, params, comp, ident)
            params = aggregation_update(params, cache, hp)
        xi_prev = xi
        if t >= steps - tail:
            avg += params["w"]
    return float(torch.linalg.norm(avg / tail - xstar)
                 / torch.linalg.norm(xstar))


def phase_paper_fedavg(dev):
    """Paper Fig 7 and the rest of the paper's protocol on the card: L2GD
    at agg_scale 1 (400 steps) against FedAvg (200 rounds at the matched
    local rate; the gap < 0.1 as benchmarks/bench_fig7_fedavg_recovery.py
    asserts), the compressed-difference FedAvg with flat QSGD (one
    qsgd_fused launch a client and round), FedOpt, error feedback with
    top-k inside L2GD against plain top-k, and a 3 x 3 (p, lambda) grid of
    natural-compressed rollouts (auto plans: natural_pack and
    natural_reduce up, natural_fused down, one each a fresh round).  Each
    run on the card against the same run of the port on the CPU: equal
    ledgers, xi traces and branch counts, final losses within
    PAPER_LOSS_RTOL."""
    from repro_torch.kernels.dispatch import LAUNCHES, reset_launches

    reset_launches()        # the paper fedavg main path starts here
    (gpu, (gstates, gtraces, glosses)), gpu_s = timed(
        lambda: paper_fedavg_runs(dev))
    launches = dict(LAUNCHES)   # and ends here
    t0 = time.perf_counter()
    cpu, (cstates, ctraces, closses) = paper_fedavg_runs("cpu")
    cpu_s = time.perf_counter() - t0
    for name, (run, loss) in gpu.items():
        crun, closs = cpu[name]
        check(run.ledger == crun.ledger, f"{name}: ledgers differ")
        if name == "l2gd":
            same_protocol(run, crun, "fig7 l2gd")
        check(np.isfinite(loss) and abs(loss - closs)
              <= PAPER_LOSS_RTOL * abs(closs),
              f"{name}: final loss {loss} vs CPU {closs}")
    gap = abs(gpu["l2gd"][1] - gpu["fedavg"][1])
    check(gap < 0.1, f"fig7 gap {gap}")
    check(gpu["fedopt"][1] < gpu["fedopt"][0].losses[0][1],
          "fedopt: the loss did not fall")
    for f in ("xis", "branches", "n_local", "n_agg_comm", "n_agg_cached"):
        check(np.array_equal(getattr(gtraces, f), getattr(ctraces, f)),
              f"grid {f} differ")
    check(np.all(np.abs(np.asarray(glosses) - np.asarray(closses))
                 <= PAPER_LOSS_RTOL * np.abs(np.asarray(closses))),
          f"grid losses {glosses} vs CPU {closses}")
    fresh = int(np.sum(gtraces.n_agg_comm))
    want = {"qsgd_fused": FIG7_N * FIG7_ROUNDS // 2,
            "natural_pack": fresh, "natural_reduce": fresh,
            "natural_fused": fresh}
    check(launches == want, f"paper fedavg launches {launches}, the path "
          f"implies {want}")
    t0 = time.perf_counter()
    ef = {(d, use): ef_quadratic(d, use) for d in (dev, "cpu")
          for use in (True, False)}
    ef_s = time.perf_counter() - t0
    for d in (dev, "cpu"):
        check(ef[(d, True)] < ef[(d, False)],
              f"error feedback on {d}: {ef[(d, True)]} vs plain top-k "
              f"{ef[(d, False)]}")
    log(f"phase paper fedavg: fig7 L2GD at agg_scale 1 ({FIG7_STEPS} steps) "
        f"{gpu['l2gd'][1]:.6f} (CPU {cpu['l2gd'][1]:.6f}) against FedAvg "
        f"({FIG7_ROUNDS} rounds) {gpu['fedavg'][1]:.6f} (CPU "
        f"{cpu['fedavg'][1]:.6f}): gap {gap:.4f} (< 0.1); FedAvg with "
        f"flat QSGD {gpu['fedavg qsgd'][1]:.6f} ({FIG7_ROUNDS // 2} "
        f"rounds, bits/n {gpu['fedavg qsgd'][0].ledger.bits_per_client:.6e}); "
        f"FedOpt {gpu['fedopt'][1]:.6f} (start "
        f"{gpu['fedopt'][0].losses[0][1]:.6f}); grid 3 x 3 natural, "
        f"{GRID_STEPS} steps a cell, {fresh} fresh rounds, final losses "
        f"{[round(v, 4) for v in glosses]}; card {gpu_s:.1f} s, CPU "
        f"{cpu_s:.1f} s; error feedback (top-k 10%) / plain top-k "
        f"distance to x*: card {ef[(dev, True)]:.4f} / "
        f"{ef[(dev, False)]:.4f}, CPU {ef[('cpu', True)]:.4f} / "
        f"{ef[('cpu', False)]:.4f} ({ef_s:.1f} s); launches {launches}")


# --------------------------------------------------------------------------
# phase fedavg lm: FedAvg and FedOpt on stablelm-1.6b at full width and
# depth
# --------------------------------------------------------------------------

def phase_fedavg_lm(dev):
    """stablelm-1.6b at full width and depth, f32, remat on, dense
    attention, 2 clients x one 4096-token sequence of the token stream a
    round: run_fedavg 2 rounds (one local SGD step a client) with the
    leafwise QSGD compressed difference and its EF memory (one
    qsgd_dequantized launch a leaf, client and round: 44), then run_fedopt
    2 rounds (Adam on the server, exact deltas: no kernel).  Seconds a
    round, peak memory; the ledger exact, params and losses finite,
    FedOpt's params not FedAvg's, peak <= 70 GB.  (No round runs under
    the profiler: the profiler's 60-80 s are kept for the MoE phases.)"""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import QSGD, make_plan, prng
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.data import TokenStream
    from repro_torch.fl import run_fedavg, run_fedopt
    from repro_torch.kernels.dispatch import LAUNCHES, reset_launches
    from repro_torch.launch.steps import param_shapes, stacked_grad_fn
    from repro_torch.models import init_params

    cfg = get_config("stablelm-1.6b")
    check(cfg.remat and cfg.attn_impl == "dense", "the phase's configuration")
    n = TRAIN_CLIENTS
    stacked = stacked_grad_fn(cfg)

    def grad_fn(p, b):
        # one client: the stacked gradient at a client axis of 1 (views)
        losses, grads = stacked(tree_map(lambda a: a[None], p),
                                tree_map(lambda a: a[None], b))
        return losses[0], tree_map(lambda g: g[0], grads)

    stream = TokenStream(n_clients=n, vocab=cfg.vocab_size, batch=TRAIN_B,
                         seq=TRAIN_S)
    batches = lambda r, i: [{"tokens": stream.batch_at(r)[i]}]
    shapes = param_shapes(cfg)
    up_bits = make_plan(QSGD(), shapes, transport="leafwise").round_bits()
    down_bits = 32.0 * STABLELM_PARAMS
    stamps = []

    def stamp(params):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return 0.0

    def fed(fn, rounds, **kw):
        stamps.clear()
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        run = fn(prng.PRNGKey(4), init_params(
            torch.Generator(device=dev).manual_seed(0), cfg, dev), grad_fn,
            batches, n, rounds, local_lr=0.05, eval_fn=stamp, eval_every=1,
            device=dev, **kw)
        return run, [float(t) for t in np.diff(stamps)]

    plan = make_plan(QSGD(), transport="leafwise")
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()            # the FedAvg main path starts here
    avg, avg_s = fed(run_fedavg, FEDAVG_ROUNDS, compressor=plan)
    launches = dict(LAUNCHES)   # and ends here
    avg_peak = torch.cuda.max_memory_allocated(dev)
    # a leaf's QSGD: one draw (one threefry launch) and one kernel
    want = {"qsgd_dequantized": FEDAVG_ROUNDS * n * STABLELM_LEAVES,
            DRAW_KERNEL: FEDAVG_ROUNDS * n * STABLELM_LEAVES}
    check(launches == want, f"fedavg lm launches {launches}, the path "
          f"implies {want}")
    check(avg.ledger.rounds == FEDAVG_ROUNDS
          and avg.ledger.uplink_bits_per_client == FEDAVG_ROUNDS * up_bits
          and avg.ledger.downlink_bits_per_client
          == FEDAVG_ROUNDS * down_bits, "fedavg lm ledger")
    check(all(np.isfinite(v) for _, v in avg.losses), "fedavg lm losses")
    for leaf in tree_leaves(avg.params):
        check(bool(torch.isfinite(leaf).all()), "fedavg lm params")
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()            # the FedOpt path: exact deltas, no kernel
    opt, opt_s = fed(run_fedopt, FEDAVG_ROUNDS, server_lr=1e-3)
    check(not LAUNCHES, f"fedopt lm launched {dict(LAUNCHES)}")
    opt_peak = torch.cuda.max_memory_allocated(dev)
    check(all(np.isfinite(v) for _, v in opt.losses), "fedopt lm losses")
    differ = False
    for a, b in zip(tree_leaves(opt.params), tree_leaves(avg.params)):
        check(bool(torch.isfinite(a).all()), "fedopt lm params")
        differ = differ or not torch.equal(a, b)
    check(differ, "fedopt's params equal fedavg's")
    check(max(avg_peak, opt_peak) <= TRAIN_PEAK,
          f"fedavg lm peak {avg_peak / 1e9:.2f} / {opt_peak / 1e9:.2f} GB")
    log(f"phase fedavg lm: stablelm-1.6b, 24 layers, {n} clients x one "
        f"{TRAIN_S}-token sequence a round, one local SGD step a client; "
        f"FedAvg (leafwise QSGD difference, EF memory) seconds a round "
        f"{[round(t, 3) for t in avg_s]}, mean client losses "
        f"{[round(v, 5) for _, v in avg.losses]}, peak "
        f"{avg_peak / 1e9:.2f} GB, launches {launches}; FedOpt (Adam, exact "
        f"deltas) seconds a round {[round(t, 3) for t in opt_s]}, losses "
        f"{[round(v, 5) for _, v in opt.losses]}, peak "
        f"{opt_peak / 1e9:.2f} GB; bits/n a round {up_bits:.0f} up + "
        f"{down_bits:.0f} down")
    del avg, opt
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# phase async width: partial participation and the async fault engine on
# the width trainer
# --------------------------------------------------------------------------

def host_copy(tree):
    from repro_torch.core.tree import tree_map
    return tree_map(lambda a: a.cpu(), tree)


def equal_by_value(tree, host, dev):
    """Every leaf of ``tree`` equals ``host``'s (on the CPU) in value:
    -0.0 == +0.0, as the keystone compares."""
    import torch
    from repro_torch.core.tree import tree_leaves
    return all(torch.equal(a, b.to(dev))
               for a, b in zip(tree_leaves(tree), tree_leaves(host)))


def async_width_run(dev, name, down_transport, xi, *, faults=None,
                    participation=None, seeded, targets, grad_fn, n,
                    dims=None):
    """One run_l2gd of the width trainer (packed uplink): (run, ms a step,
    peak bytes, launches)."""
    import torch
    from repro_torch.core import L2GDHyper, make_compressor, make_plan, prng
    from repro_torch.fl import run_l2gd
    from repro_torch.kernels.dispatch import LAUNCHES

    comp = make_compressor(name)
    one = width_tree(1, lambda s: torch.empty(s[1:], device="meta"), dims)
    up = make_plan(comp, one, transport="packed")
    down = make_plan(comp, one, transport=down_transport)
    before = dict(LAUNCHES)
    if dev != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    run = run_l2gd(prng.PRNGKey(0), width_tree(n, seeded(0, 0.02), dims),
                   grad_fn, L2GDHyper(eta=0.5, lam=1.0, p=0.3, n=n),
                   lambda k: targets, len(xi), plan=(up, down), xi_trace=xi,
                   participation=participation, faults=faults, device=dev)
    peak = 0
    if dev != "cpu":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
    ms = (time.perf_counter() - t0) / len(xi) * 1e3
    launches = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                if v - before.get(k, 0)}
    return run, ms, peak, launches


def width_launches(name, down_transport, fresh, late_folds=0):
    """The kernels a width run launches: the packed uplink's pack (one
    launch for all clients) and a weighted reduce a fresh round, plus
    ``late_folds`` reduces of stragglers into the delay buffer, the
    downlink's fused kernel (flat) or pack and, for QSGD, unpack (packed;
    natural merges in plain PyTorch)."""
    p = "qsgd" if name == "qsgd" else "natural"
    want = {f"{p}_pack": fresh, f"{p}_reduce": fresh + late_folds}
    if down_transport == "flat":
        want[f"{p}_fused"] = fresh
    else:
        want[f"{p}_pack"] += fresh
        if name == "qsgd":
            want["qsgd_unpack"] = fresh
    return want


def chaos_plan():
    from repro_torch.fl import FaultPlan, geometric_latency_probs
    return FaultPlan(max_delay=2, latency_probs=geometric_latency_probs(1.0, 3),
                     drop_rate=0.1, crash_rate=0.05, quorum=0.75,
                     staleness_decay=0.5)


def chaos_late_folds(n, xi, participation):
    """The straggler reduces of a chaos run: one for each fresh round and
    delay at which a straggler lands, as the engine schedules them on the
    host from the run's fault draws and participation masks (the protocol
    key of async_width_run)."""
    import numpy as np
    from repro_torch.core import prng
    from repro_torch.core.async_engine import arrival_schedule
    from repro_torch.core.rollout import participant_count, window_masks
    from repro_torch.fl.faults import fault_draws

    plan, key, steps = chaos_plan(), prng.PRNGKey(0), np.arange(len(xi))
    lats, drps, crss = fault_draws(prng.split(key)[0], steps, n, plan)
    masks = window_masks(key, n, participation, 0, len(xi))
    q = plan.quorum_count(participant_count(n, participation))
    folds = 0
    for k in steps[1:]:
        if xi[k] == 1 and xi[k - 1] == 0:           # a fresh round opens
            _, _, late, eff, _ = arrival_schedule(
                np.asarray(masks[k], np.float32), lats[k], drps[k], crss[k],
                q, plan)
            folds += len(set(eff[late > 0].tolist()))
    return folds


def check_faults(run, n, rounds, part, up_bits, down_bits, what):
    """Conservation of the fault events and the ledger against a hand
    count from ``run.fault_stats``."""
    st = run.fault_stats
    check(st["sent"] == st["delivered"] + st["dropped"] + st["evicted"]
          + st["rejected"], f"{what}: events not conserved {st}")
    check(st["sent"] + st["crashed"] == rounds * part,
          f"{what}: sent + crashed {st}")
    check(run.ledger.rounds == rounds
          and run.ledger.uplink_bits_per_client == st["sent"] / n * up_bits
          and run.ledger.downlink_bits_per_client
          == st["sent"] / n * down_bits, f"{what}: ledger {run.ledger}")


def phase_async_width(dev):
    """The width trainer (stablelm-1.6b's tree at 4 of 24 layers, d =
    411,060,224 a client, 8 clients, packed uplink) on the async fault
    engine and with partial participation, QSGD and then natural:
    (a) run_l2gd(faults=FaultPlan()) against the synchronous run on the
    card, flat and packed downlink, forced xi [0, 1, 1, 0, 1]: params
    equal in value, ledger, xi trace and branch counts exact; (b) chaos:
    10 steps, xi [0, 1] x 5, the fault plan of chaos_plan() and
    participation 0.75 (6 of 8 clients), packed downlink: the events
    conserved, the ledger equal to a hand count from run.fault_stats, at
    least one straggler folded at a weight below 1 (the weighted reduce
    kernel), params finite, peak <= 70 GB; (c) participation 0.5 alone,
    flat downlink: the ledger charges 4/8 of a round; (d) (b) at a reduced
    width (d = 1,057,408) on the card against the port on the CPU: equal
    fault_stats, xi trace and ledger; params within one downlink level
    (QSGD) or equal in value (natural, whose kernels are bit-exact)."""
    import torch
    from repro_torch.core import make_compressor, make_plan
    from repro_torch.core.rollout import participant_count
    from repro_torch.core.tree import tree_leaves
    from repro_torch.fl import FaultPlan
    from repro_torch.kernels.dispatch import LAUNCHES, reset_launches

    n = WIDTH_CLIENTS
    seeded, targets, grad_fn = width_objective(dev, n)
    kw = dict(seeded=seeded, targets=targets, grad_fn=grad_fn, n=n)
    one = width_tree(1, lambda s: torch.empty(s[1:], device="meta"))
    for name in ("qsgd", "natural"):
        comp = make_compressor(name)
        up_bits = make_plan(comp, one, transport="packed").round_bits()
        ms, want, lines = {}, {}, []
        reset_launches()        # this codec's async main path starts here
        for down in ("flat", "packed"):
            down_bits = make_plan(comp, one, transport=down).round_bits()
            sync, ms[f"sync {down}"], _, got = async_width_run(
                dev, name, down, TRAIN_XI, **kw)
            want[f"sync {down}"] = (got, width_launches(name, down, 2))
            host = host_copy(sync.state.params)
            protocol = (list(sync.xis), sync.n_local, sync.n_agg_comm,
                        sync.n_agg_cached, sync.ledger)
            del sync
            null, ms[f"null {down}"], _, got = async_width_run(
                dev, name, down, TRAIN_XI, faults=FaultPlan(), **kw)
            want[f"null {down}"] = (got, width_launches(name, down, 2))
            check((list(null.xis), null.n_local, null.n_agg_comm,
                   null.n_agg_cached, null.ledger) == protocol,
                  f"{name} {down}: null plan protocol or ledger differs")
            check(null.fault_stats["sent"] == null.fault_stats["fresh"]
                  == 2 * n, f"{name}: null plan events {null.fault_stats}")
            check(equal_by_value(null.state.params, host, dev),
                  f"{name} {down}: the null plan's params differ from the "
                  "synchronous run's")
            del null, host
        part = participant_count(n, 0.75)
        chaos, ms["chaos"], peak, got = async_width_run(
            dev, name, "packed", CHAOS_XI, faults=chaos_plan(),
            participation=0.75, **kw)
        want["chaos"] = (got, width_launches(
            name, "packed", 5, chaos_late_folds(n, CHAOS_XI, 0.75)))
        down_bits = make_plan(comp, one, transport="packed").round_bits()
        check_faults(chaos, n, 5, part, up_bits, down_bits, f"{name} chaos")
        check(chaos.fault_stats["stale"] >= 1, f"{name} chaos: no straggler "
              f"folded at a weight below 1 {chaos.fault_stats}")
        check(peak <= TRAIN_PEAK, f"{name} chaos peak {peak / 1e9:.2f} GB")
        for leaf in tree_leaves(chaos.state.params):
            check(bool(torch.isfinite(leaf).all()), "non-finite params")
        stats = chaos.fault_stats
        del chaos
        sampled, ms["participation 0.5"], _, got = async_width_run(
            dev, name, "flat", TRAIN_XI, participation=0.5, **kw)
        want["participation 0.5"] = (got, width_launches(name, "flat", 2))
        flat_bits = make_plan(comp, one, transport="flat").round_bits()
        check(sampled.ledger.rounds == 2
              and sampled.ledger.uplink_bits_per_client == 2 * up_bits / 2
              and sampled.ledger.downlink_bits_per_client
              == 2 * flat_bits / 2, f"{name}: participation 0.5 ledger")
        del sampled
        launches = dict(LAUNCHES)   # and ends here
        for what, (got, expect) in want.items():
            check(got == expect, f"{name} {what}: launches {got}, the path "
                  f"implies {expect}")
        torch.cuda.empty_cache()
        log(f"phase async width ({name}): {n} clients x d={WIDTH_D}, packed "
            f"uplink; ms a step (first-call costs included): " +
            ", ".join(f"{k} {v:.1f}" for k, v in ms.items()) +
            f"; null plan == synchronous (flat, packed downlink) by value; "
            f"chaos (10 steps, 5 fresh rounds, {part} of {n} clients, "
            f"max_delay 2, decay 0.5): {stats}, peak {peak / 1e9:.2f} GB; "
            f"launches {launches} (chaos {want['chaos'][0]})")
        phase_async_reduced(dev, name)
    del targets
    torch.cuda.empty_cache()


def phase_async_reduced(dev, name):
    """(d): the chaos run at ASYNC_DIMS on the card and on the CPU."""
    import torch
    from repro_torch.core import flatbuf
    from repro_torch.core.tree import tree_leaves, tree_map

    n = WIDTH_CLIENTS
    runs = {}
    for device in (dev, "cpu"):
        seeded, targets, grad_fn = width_objective(
            device, n, ASYNC_DIMS, host_seeds=True)
        runs[device] = async_width_run(
            device, name, "packed", CHAOS_XI, faults=chaos_plan(),
            participation=0.75, seeded=seeded, targets=targets,
            grad_fn=grad_fn, n=n, dims=ASYNC_DIMS)[0]
    gpu, cpu = runs[dev], runs["cpu"]
    same_protocol(gpu, cpu, f"{name} async reduced")
    check(gpu.fault_stats == cpu.fault_stats,
          f"{name} async reduced: fault_stats {gpu.fault_stats} vs "
          f"{cpu.fault_stats}")
    worst, level = 0.0, 0.0
    for a, b in zip(tree_leaves(gpu.state.params),
                    tree_leaves(cpu.state.params)):
        worst = max(worst, float(torch.max(torch.abs(a.cpu() - b))))
        check(name == "qsgd" or torch.equal(a.cpu(), b),
              "natural async reduced: params differ from the CPU's")
    if name == "qsgd":
        # one level of the downlink quantizer: the largest bucket norm of
        # the mean model, raveled as the flat engine ravels it, / levels
        mean = tree_map(lambda a: a.mean(0), cpu.state.params)
        layout = flatbuf.layout_of(mean, 2048)
        level = float(torch.linalg.vector_norm(flatbuf.bucketize(
            flatbuf.ravel(layout, mean), 2048), dim=1).max()) / 127
    check(worst <= level, f"{name} async reduced: max |gpu - cpu| {worst} "
          f"> one level {level}")
    log(f"phase async width ({name}, reduced d={ASYNC_D}): card against CPU "
        f"equal xi trace, branch counts, ledger and fault_stats "
        f"{gpu.fault_stats}; max |w_gpu - w_cpu| {worst:.3g} (bound "
        f"{'one level ' + format(level, '.3g') if name == 'qsgd' else 0})")


# --------------------------------------------------------------------------
# the MoE and MLA family: routes, spans, prefill / serve, train, grad
# --------------------------------------------------------------------------

def flip_bound(pairs):
    """The most flips ROUTE_FLIP_RATE allows among ``pairs`` (token,
    slot) pairs: a Poisson mean and five of its standard deviations."""
    mean = ROUTE_FLIP_RATE * pairs
    return mean + 5 * mean ** 0.5


class Routes:
    """Record the top-k experts of every ``models.moe._route`` call and
    the kept set of every dispatch (``_positions``), on the device: no
    call syncs, the counts are read after the run.  With ``force`` (the
    top-k of an earlier run, call by call) every call takes those experts
    and counts where its own differ (the flipped (token, slot) pairs):
    the gates are this run's, gathered at the forced experts and
    normalized as ``_route`` does (bit for bit ``_route``'s own values
    where nothing flips)."""

    def __init__(self, force=None):
        self.force, self.topi, self.keep, self.flipped = force, [], [], []

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self.saved = (moe._route, moe._positions)
        route, positions = self.saved

        def routed(x, router, k):
            gates, topv, topi = route(x, router, k)
            if self.force is not None:
                want = self.force[len(self.topi)].to(topi.device) \
                    .reshape(topi.shape)
                self.flipped.append((want != topi).sum())
                topi = want
                topv = torch.gather(gates, -1, topi)
                topv = topv / torch.clamp(
                    torch.sum(topv, dim=-1, keepdim=True), min=1e-9)
            self.topi.append(topi)
            return gates, topv, topi

        def recorded(topi, n_experts, capacity):
            out = positions(topi, n_experts, capacity)
            self.keep.append(out[2])
            return out

        moe._route, moe._positions = routed, recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._route, moe._positions = self.saved

    @property
    def pairs(self):
        return sum(t.numel() for t in self.topi)

    @property
    def flips(self):
        return sum(int(f) for f in self.flipped)

    @property
    def assigned(self):
        return sum(k.numel() for k in self.keep)

    @property
    def dropped(self):
        return sum(int((~k).sum()) for k in self.keep)

    def by_layer(self, n_moe):
        """[(topi (G, S, k), keep (G, k, S))] a MoE layer: the run's
        calls, step-major (decode: a call a step and layer), joined along
        the tokens."""
        import torch
        steps_ = len(self.topi) // n_moe
        calls = range(n_moe)
        topi = [torch.cat([self.topi[s * n_moe + i] for s in range(steps_)],
                          1) for i in calls]
        keep = [torch.cat([self.keep[s * n_moe + i].reshape(
            self.topi[s * n_moe + i].shape[0],
            self.topi[s * n_moe + i].shape[2], -1)
            for s in range(steps_)], 2) for i in calls]
        return list(zip(topi, keep))

    def check_flips(self, what):
        return flips_line(what, self.flips, self.pairs)


def flips_line(what, flips, pairs):
    bound = flip_bound(pairs)
    check(flips <= bound, f"{what}: {flips} of {pairs} (token, slot) routes "
          f"flipped, more than the bound {bound:.1f}")
    return (f"{flips} of {pairs} (token, slot) routes flipped (bound "
            f"{bound:.1f})")


def route_agreement(first, second, n_moe):
    """Two unforced runs over the same sequences: (the line counting the
    (token, slot) routes that differ, the (G, S) mask of the tokens that
    agree: their routes and kept slots equal in every MoE layer, and
    those of every earlier token of their sequence).  Under causal
    attention no difference reaches those tokens, so their values differ
    by rounding alone.  The count takes in the cascades (a token whose
    expert flipped routes its later layers afresh), so only a forced run
    counts the flips themselves (``Routes(force=...)``)."""
    import torch
    differ_pairs = pairs = 0
    differ = None
    for (ta, ka), (tb, kb) in zip(first.by_layer(n_moe),
                                  second.by_layer(n_moe)):
        tb, kb = tb.to(ta.device), kb.to(ta.device)
        differ_pairs += int((ta != tb).sum())
        pairs += ta.numel()
        d = (ta != tb).any(-1) | (ka != kb).any(1)
        differ = d if differ is None else differ | d
    clean = torch.cumsum(differ.to(torch.int32), dim=1) == 0
    return (f"{differ_pairs} of {pairs} (token, slot) routes differ "
            "(cascades included)"), clean


def clean_err(a, b, clean):
    """max |a - b| over the tokens ``clean`` marks ((G, S) of (G, S, V)
    logits) and their count."""
    diff = (a - b).abs_().masked_fill_(~clean[..., None], 0.0)
    return float(diff.max()), int(clean.sum())


class Recorded:
    """The program's spans (``repro_torch.tracing``) that close inside the
    block.  The profiler turns them on, so a block around a profile holds
    the spans of what it profiled; each carries the device time between
    its CUDA events (one stream: a span's own work)."""

    def __enter__(self):
        from repro_torch import tracing
        self.first = len(tracing.spans())
        return self

    def __exit__(self, *exc):
        from repro_torch import tracing
        self.spans = tracing.spans()[self.first:]

    def ms(self, name):
        return 1e3 * sum(s.device_s for s in self.spans if s.name == name)

    def moe_shares(self, wall_ms):
        """The MoE layer's parts: the router (``moe.router``), the expert
        products (``moe.experts``), dispatch / combine (the gather
        dispatch ``moe.dispatch`` less the two) and the dispatch's
        backward gathers (``moe.gather_bwd``)."""
        ms = {k: self.ms(f"moe.{k}")
              for k in ("dispatch", "router", "experts", "gather_bwd")}
        parts = {"router": ms["router"], "expert GEMMs": ms["experts"],
                 "dispatch / combine": ms["dispatch"] - ms["router"]
                 - ms["experts"], "dispatch backward": ms["gather_bwd"]}
        return "moe spans: " + ", ".join(
            f"{k} {v:.1f} ms ({v / wall_ms:.1%})" for k, v in parts.items()
            if v or k != "dispatch backward")


def phase_moe_prefill(dev, arch, layers):
    """``arch`` at full width (``layers`` of its layers; all by default),
    f32, seeded random weights, on B = 2 sequences of 4096 tokens:
    build_prefill_step (GQA configs with attn_impl="flash": one flash
    launch a layer; MLA: the dense latent prefill, no kernel), its
    profile with the MoE spans, the dropped share at the configured
    capacity factor, then forward with flash against forward with dense
    attention (MLA: the step against forward's last position): dense on
    its own routes, held on the tokens whose routes agree (the flips
    counted), then dense taking flash's routes, held on every token.
    Returns (cfg, params, tokens, launches)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.kernels.dispatch import LAUNCHES, reset_launches
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import forward, init_params, param_count

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    flash = cfg.mixer == "gqa"
    if flash:
        cfg = dataclasses.replace(cfg, attn_impl="flash")
    torch.cuda.reset_peak_memory_stats(dev)
    params, init_s = timed(lambda: init_params(
        torch.Generator(device=dev).manual_seed(0), cfg))
    n_params = MOE_SERVE[(arch, layers)]
    check(param_count(params) == n_params, f"{arch} parameter count")
    tokens = torch.from_numpy(TokenStream(
        n_clients=1, vocab=cfg.vocab_size, batch=PREFILL_B,
        seq=PREFILL_S).batch_at(0)[0]).long().to(dev)
    batch = {"tokens": tokens}
    prefill = build_prefill_step(cfg)
    reset_launches()            # this prefill main path starts here
    with Routes() as routes:
        last, first_s = timed(lambda: prefill(params, batch))
    launches = dict(LAUNCHES)   # and ends here
    want = {"flash_attention": cfg.n_layers} if flash else {}
    check(launches == want, f"{arch} prefill launches {launches}, the path "
          f"implies {want}")
    check(last.shape == (PREFILL_B, cfg.vocab_size)
          and bool(torch.isfinite(last).all()), f"{arch} prefill logits")
    dropped = routes.dropped / routes.assigned
    _, prefill_s = timed(lambda: prefill(params, batch))
    peak = torch.cuda.max_memory_allocated(dev)
    with Recorded() as spans:
        wall, by_kind, count = device_profile(lambda: prefill(params, batch))
    log(profile_line(f"{arch} prefill step", wall, by_kind, count) + "; "
        + spans.moe_shares(wall))
    seen, restore = [], None
    if flash:   # forward keeps the last layer's attention operands
        from repro_torch.kernels.flash_attention import kernel as fk
        from repro_torch.kernels.flash_attention import ops as flash_ops
        restore = flash_ops.flash_attention_op

        def keep_last(q, k, v, **kw):
            out = restore(q, k, v, **kw)
            seen[:] = [(q, k, v, kw, out)]
            return out

        flash_ops.flash_attention_op = keep_last
    try:
        with torch.no_grad(), Routes() as first:
            logits, fwd_s = timed(lambda: forward(params, cfg, batch)[0])
    finally:
        if restore is not None:
            flash_ops.flash_attention_op = restore
    check(bool(torch.isfinite(logits).all()), f"{arch}: non-finite logits")
    step_err = float(torch.max(torch.abs(logits[:, -1] - last)))
    check(step_err <= 1e-5 * float(last.abs().max()),
          f"{arch} prefill step vs forward's last position: {step_err:.3g}")
    line = f"step vs forward's last position max |d| {step_err:.3g}"
    if flash:
        dense_cfg = dataclasses.replace(cfg, attn_impl="dense")
        n_moe = cfg.n_layers - cfg.first_dense_layers
        reset_launches()
        with torch.no_grad(), Routes() as second:
            dense, dense_s = timed(lambda: forward(params, dense_cfg,
                                                   batch)[0])
        check(not LAUNCHES, f"dense forward launched {dict(LAUNCHES)}")
        flips, clean = route_agreement(first, second, n_moe)
        scale = float(dense.abs().max())
        own_err, agree = clean_err(logits, dense, clean)
        check(own_err <= MOE_LOGIT_RTOL * scale, f"{arch} flash vs dense on "
              f"the {agree} tokens whose routes agree: {own_err:.3g} > "
              f"{MOE_LOGIT_RTOL:g} x {scale:.3g}")
        del dense, second
        with torch.no_grad(), Routes(force=first.topi) as third:
            dense = forward(params, dense_cfg, batch)[0]
        forced = third.check_flips(f"{arch} flash vs dense (forced)")
        diff = torch.abs(logits - dense)
        err = float(diff.max())
        p999 = float(torch.quantile(diff.flatten()[::97], 0.999))
        q, k, v, kw, out = seen.pop()
        plain = fk._plain(q, k, v, kw["causal"], kw["window"])
        layer_err = float(torch.max(torch.abs(out - plain)))
        layer_bound = FLASH_TOL * max(1.0, float(plain.abs().max()))
        del q, k, v, out, plain, diff
        line += (f"; forward flash {fwd_s:.3f} s, dense {dense_s:.3f} s; "
                 f"dense on its own routes: {flips}, logits max |d| on the "
                 f"{agree} of {clean.numel()} tokens before a sequence's "
                 f"first differing route {own_err:.3g} = "
                 f"{own_err / scale:.3g} x max |logit| {scale:.3g}; dense "
                 f"on flash's routes: {forced}, logits max |d| {err:.3g} = "
                 f"{err / scale:.3g} x (bound {MOE_LOGIT_RTOL:g} x; 99.9th "
                 f"percentile {p999:.3g}); layer "
                 f"{cfg.n_layers - 1} kernel vs plain on its own operands "
                 f"max |d| {layer_err:.3g}")
        log(f"{arch}: {line}")
        check(layer_err <= layer_bound, f"{arch} layer {cfg.n_layers - 1} "
              f"flash vs plain: {layer_err:.3g} > {layer_bound:.3g}")
        check(err <= MOE_LOGIT_RTOL * scale, f"{arch} flash vs dense "
              f"logits: {err:.3g} > {MOE_LOGIT_RTOL:g} x {scale:.3g}")
        del dense
    del logits
    log(f"phase moe prefill: {arch}, {cfg.n_layers} layers, {n_params:,} "
        f"params (init {init_s:.2f} s), {cfg.n_experts} experts top-"
        f"{cfg.experts_per_token}, {cfg.n_shared_experts} shared, mixer "
        f"{cfg.mixer}; B={PREFILL_B} S={PREFILL_S}: prefill step "
        f"{first_s:.3f} s first, {prefill_s:.3f} s second, peak "
        f"{peak / 1e9:.2f} GB; dropped assignments at capacity factor "
        f"{cfg.capacity_factor:g}: {routes.dropped} of {routes.assigned} "
        f"({dropped:.4%}); {line}; launches {launches}")
    return cfg, params, tokens, launches


def phase_moe_serve(dev, cfg, params, tokens):
    """The serve phase at the capacity factor n_experts / k, where a
    prefill group's capacity is S and nothing drops (decode's groups
    never drop), so decode and forward compute the same function; the
    forward takes decode's routes where an ulp flips one.  MLA reports
    its latent cache's bytes a token and layer."""
    import dataclasses
    cfg = dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
    phase_serve(dev, cfg, params, tokens, moe=True)


def phase_route_seeds(dev):
    """ROUTE_ARCH at full width and depth at each of ROUTE_SEEDS of its
    weights, on the prefill batch: hidden with flash attention, then with
    dense attention taking flash's routes, the flips counted and held to
    flip_bound (phase moe prefill reads seed 0)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.models import hidden, init_params

    cfg = dataclasses.replace(get_config(ROUTE_ARCH), attn_impl="flash")
    dense_cfg = dataclasses.replace(cfg, attn_impl="dense")
    batch = {"tokens": torch.from_numpy(TokenStream(
        n_clients=1, vocab=cfg.vocab_size, batch=PREFILL_B,
        seq=PREFILL_S).batch_at(0)[0]).long().to(dev)}
    lines = []
    for seed in ROUTE_SEEDS:
        params = init_params(torch.Generator(device=dev).manual_seed(seed),
                             cfg)
        with torch.no_grad(), Routes() as first:
            hidden(params, cfg, batch)
        with torch.no_grad(), Routes(force=first.topi) as second:
            hidden(params, dense_cfg, batch)
        lines.append(f"seed {seed}: " + second.check_flips(
            f"{ROUTE_ARCH} seed {seed} flash vs dense"))
        del params, first, second
    torch.cuda.empty_cache()
    log(f"phase route seeds: {ROUTE_ARCH}, {cfg.n_layers} layers, "
        f"B={PREFILL_B} S={PREFILL_S}, flash against dense attention: "
        + "; ".join(lines))


def phase_moe_grad(dev):
    """One client's loss and gradient of MOE_GRAD_ARCH at full width and
    MODEL_GRAD_LAYERS layers (remat on) on one sequence of MODEL_GRAD_S
    tokens, on the card and on the CPU from the same params.  The routes
    are compared first: the card's recompute must route as its forward
    did, and the CPU takes the card's routes where an ulp flips one (the
    flips counted and bounded).  Each leaf within MODEL_GRAD_RTOL x its
    max."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_flatten, tree_unflatten
    from repro_torch.data import TokenStream
    from repro_torch.kernels.dispatch import LAUNCHES, reset_launches
    from repro_torch.models import init_params, loss_fn

    cfg = dataclasses.replace(get_config(MOE_GRAD_ARCH),
                              n_layers=MODEL_GRAD_LAYERS)
    params = init_params(torch.Generator(device=dev).manual_seed(3), cfg)
    leaves, treedef = tree_flatten(params)
    names = tree_flatten(_key_paths(params))[0]
    del params
    tokens = torch.from_numpy(TokenStream(
        n_clients=1, vocab=cfg.vocab_size, batch=1,
        seq=MODEL_GRAD_S).batch_at(0)[0]).long()

    def grads(device, force=None):
        own = [a.detach().to(device).requires_grad_() for a in leaves]
        with Routes(force) as routes:
            loss, metrics = loss_fn(tree_unflatten(treedef, own), cfg,
                                    {"tokens": tokens.to(device)})
            got = torch.autograd.grad(loss, own)
        return loss.detach(), float(metrics["aux"].detach()), got, routes

    reset_launches()
    (loss, aux, got, card), gpu_s = timed(lambda: grads(dev))
    check(not LAUNCHES, f"moe grad launched {dict(LAUNCHES)}")
    n = cfg.n_layers
    check(len(card.topi) == 2 * n and all(
        torch.equal(card.topi[i], card.topi[2 * n - 1 - i])
        for i in range(n)), "the recompute routed otherwise than the forward")
    t0 = time.perf_counter()
    cpu_loss, cpu_aux, want, cpu = grads("cpu", [t.cpu() for t in card.topi])
    cpu_s = time.perf_counter() - t0
    flips = cpu.check_flips("moe grad, card vs CPU")
    loss_rel = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
    check(loss_rel <= MODEL_GRAD_RTOL, f"moe loss {loss_rel:.3g}")
    worst, at = 0.0, None
    for i, (a, b) in enumerate(zip(got, want)):
        check(bool(torch.isfinite(a).all()), "non-finite gradient")
        rel = float(torch.max(torch.abs(a.cpu() - b))) \
            / max(float(b.abs().max()), 1e-30)
        if rel >= worst:
            worst, at = rel, i
    check(worst <= MODEL_GRAD_RTOL, f"moe gradient leaf {names[at]}: "
          f"{worst:.3g} x max |cpu| > {MODEL_GRAD_RTOL}")
    log(f"phase moe grad: {MOE_GRAD_ARCH} at full width, {n} layers (remat "
        f"{cfg.remat}), one sequence of {MODEL_GRAD_S} tokens: the card "
        f"({gpu_s:.2f} s; no kernel) against the CPU ({cpu_s:.1f} s): "
        f"{flips} (the CPU took the card's); loss within {loss_rel:.3g} "
        f"(aux {aux:.6f} / {cpu_aux:.6f}), the worst of {len(want)} leaves "
        f"{names[at]} within {worst:.3g} x its max (bound "
        f"{MODEL_GRAD_RTOL})")


def local_steps_identical(step, state, batch, key):
    """Two local steps from one state: every param bit-identical."""
    import torch
    from repro_torch.core.tree import tree_leaves
    a = step(state, batch, 0, key)[0].params
    b = step(state, batch, 0, key)[0].params
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


# --------------------------------------------------------------------------
# phase fleet width: heterogeneous fleets and the bandwidth controller on
# the width cell
# --------------------------------------------------------------------------

def fleet_run(dev, up, xi, *, faults=None, participation=None, seeded,
              targets, grad_fn, n, down=None):
    """One run_l2gd of the width trainer with uplink ``up`` (a plan or a
    fleet) and an identity downlink: (run, ms a step, peak bytes,
    launches)."""
    import torch
    from repro_torch.core import Identity, L2GDHyper, prng
    from repro_torch.fl import run_l2gd
    from repro_torch.kernels.dispatch import LAUNCHES

    before = dict(LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    run = run_l2gd(prng.PRNGKey(0), width_tree(n, seeded(0, 0.02)),
                   grad_fn, L2GDHyper(eta=0.5, lam=1.0, p=0.3, n=n),
                   lambda k: targets, len(xi), client_comp=up,
                   master_comp=down or Identity(), xi_trace=xi,
                   participation=participation, faults=faults, device=dev)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / len(xi) * 1e3
    peak = torch.cuda.max_memory_allocated(dev)
    launches = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                if v - before.get(k, 0)}
    torch.cuda.empty_cache()    # the next run's wire buffers differ
    return run, ms, peak, launches


def fleet_plain_check(dev, fleet, params):
    """The mixed fleet's mean on the card (``fleet_mean``: the wire
    cohorts' pack and reduce kernels) against a plain computation on the
    same inputs: client i alone under ``fleet.plan_for(i)`` with key i of
    ``split(k, n)`` (the reference's key schedule) through the plain
    versions of the codecs on the card, summed cohort by cohort in the
    fleet's order, one division.  The QSGD cohort's pack (levels 4) is
    held as phase width kernels holds the pack: the kernel's buffer and
    seed words equal client i's own, its codes bit-exact given its
    bucket norms, the norms within NORM_ULPS of the plain sum.  The plain
    decode takes the kernel's norms, so the means agree within float32
    rounding, 8 eps x sum_i |C_i(x_i)| / n an element.  Then that pack
    timed against its bound and its plain version.  Returns the line."""
    import torch
    from repro_torch.core import flatbuf, prng
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.fl import fleet_mean
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.natural import kernel as nk
    from repro_torch.kernels.natural import ops as nops
    from repro_torch.kernels.qsgd import kernel as qk
    from repro_torch.kernels.qsgd import ops as qops
    from repro_torch.kernels.qsgd import ref

    n = fleet.n_clients
    keys = prng.split(prng.PRNGKey(11), n)
    seen, pack = [], flatbuf.qsgd_pack

    def recorded(x, seeds, *, levels):
        out = pack(x, seeds, levels=levels)
        seen.append((x, np.asarray(seeds, np.uint32), levels) + tuple(out))
        return out

    flatbuf.qsgd_pack = recorded
    try:
        mean = fleet_mean(fleet, keys, params)
    finally:
        flatbuf.qsgd_pack = pack
    check(len(seen) == 1, f"fleet mean: {len(seen)} QSGD packs")
    x, seeds, levels, codes, norms = seen.pop()
    before = dict(dispatch.LAUNCHES)
    plain_route = (qk, qops, nk, nops)
    saved = [m.use_kernel for m in plain_route]
    for m in plain_route:
        m.use_kernel = lambda *tensors: False
    total = absum = None
    norm_ulps = flipped = 0
    try:
        for c in fleet.used_cohorts:
            plan, part = fleet.cohorts[c], None
            for j, i in enumerate(fleet.clients_of(c)):
                tree = tree_map(lambda a: a[i], params)
                if plan.codec.name == "qsgd":
                    layout = flatbuf.layout_of(tree, x.shape[-1])
                    xi = flatbuf.bucketize(flatbuf.ravel(layout, tree),
                                           x.shape[-1])
                    si = flatbuf.seeds_of(keys[i])
                    check(torch.equal(xi, x[j])
                          and np.array_equal(si, seeds[j]), f"fleet mean: "
                          f"the QSGD pack's row {j} is not client {i}'s")
                    given, _ = ref.qsgd_pack_ref(xi, si, levels=levels,
                                                 norms=norms[j])
                    check(torch.equal(given, codes[j]), f"qsgd_pack levels "
                          f"{levels}: client {i}'s codes given the norms")
                    own, own_norms = ref.qsgd_pack_ref(xi, si, levels=levels)
                    norm_ulps = max(norm_ulps, ulps(own_norms, norms[j]))
                    flipped += int((own != codes[j]).sum())
                    del xi, own, own_norms
                    ci = flatbuf.unravel(layout, flatbuf.unbucketize(
                        ref.qsgd_unpack_ref(given, norms[j], levels=levels),
                        layout.d))
                else:
                    ci = plan.apply(keys[i], tree)
                ci = tree_map(lambda a: a.to(torch.float32), ci)
                if part is None:
                    part = tree_map(torch.clone, ci)
                else:
                    tree_map(lambda t, a: t.add_(a), part, ci)
                if absum is None:
                    absum = tree_map(torch.abs, ci)
                else:
                    tree_map(lambda t, a: t.add_(a.abs()), absum, ci)
                del ci
            if total is None:
                total = part
            else:
                tree_map(lambda t, a: t.add_(a), total, part)
            del part
    finally:
        for m, fn in zip(plain_route, saved):
            m.use_kernel = fn
    check(dict(dispatch.LAUNCHES) == before, "the plain fleet mean launched "
          "a kernel")
    check(norm_ulps <= NORM_ULPS, f"qsgd_pack levels {levels}: norms "
          f"{norm_ulps} ulps off")
    eps = float(np.finfo(np.float32).eps)
    err = rel = 0.0
    for m, t, a in zip(tree_leaves(mean), tree_leaves(total),
                       tree_leaves(absum)):
        d = torch.abs(m - t / n)
        tol = 8 * eps * a / n
        check(bool(torch.all(d <= tol)), "the fleet mean differs from the "
              "plain computation beyond float32 rounding")
        err = max(err, float(d.max()))
        rel = max(rel, float((d / torch.clamp(a / n, min=1e-30)).max()))
    del mean, total, absum
    nc, nb, b = x.shape
    ms = time_ms(lambda: qk.qsgd_pack(x, seeds, levels=levels), reps=10)
    plain_ms = time_ms(lambda: [ref.qsgd_pack_ref(x[j], seeds[j],
                                                  levels=levels)
                                for j in range(nc)], reps=1, warmup=1)
    nbytes = nc * nb * b * 5 + nc * nb * 4
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = 10 * nc * nb * b / PEAK_F32_OPS_PER_S * 1e3
    del x, codes, norms
    torch.cuda.empty_cache()
    return (f"mean of the mixed fleet against the plain codecs client by "
            f"client (key schedule split(k, {n})): max |d| {err:.3g}, "
            f"{rel:.3g} x sum_i |C_i| / n (bound {8 * eps:.3g}); qsgd_pack "
            f"at levels {levels} ({nc}, {nb}, {b}): codes bit-exact given "
            f"the kernel's norms, norms within {norm_ulps} ulps, {flipped} "
            f"codes of {nc * nb * b} differ under the plain "
            f"norms; {ms:.3f} ms (bound {max(bytes_ms, ops_ms):.3f} ms, "
            f"{nbytes / 1e9:.3f} GB; {bytes_ms / ms:.0%} of the memory "
            f"roofline), plain version {plain_ms:.1f} ms")


def phase_fleet_width(dev):
    """The width cell (stablelm-1.6b's tree at 4 layers, d = 411,060,224,
    8 clients, the quadratic objective) under benchmarks/bench_fleet.py's
    three-cohort mix (identity leafwise, natural flat, QSGD levels 4 on
    the narrow packed wire; client i in cohort i mod 3), identity
    downlink: (a) a uniform fleet equals its single plan in value on the
    synchronous engine and on the async engine's chaos plan (the entry
    points unwrap it to that plan, resolve_uplink, so this holds that
    they do); (b) the mixed fleet on both engines: the ledger charges
    sum_i round_bits(i) a full round (the chaos run from its delivery
    counts), a natural pack and a QSGD pack a fresh round and a reduce a
    fold for each wire cohort, peak <= 70 GB; after the synchronous run,
    the fleet's mean of its final params against the plain codecs
    (fleet_plain_check); (c) three controller rounds on a fleet with two
    adjustable QSGD cohorts: the chosen levels, the budget kept."""
    import torch
    from repro_torch.core import Identity, make_compressor, make_plan
    from repro_torch.core.tree import tree_leaves
    from repro_torch.fl import (BandwidthBudgetController, FleetPlan,
                                as_fleet_plan)
    from repro_torch.fl.ledger import BitsLedger, per_client_uplink
    from repro_torch.kernels.dispatch import reset_launches

    n = WIDTH_CLIENTS
    seeded, targets, grad_fn = width_objective(dev, n)
    kw = dict(seeded=seeded, targets=targets, grad_fn=grad_fn, n=n)
    one = width_tree(1, lambda s: torch.empty(s[1:], device="meta"))
    mixed = FleetPlan(cohorts=(
        make_plan(Identity(), one, transport="leafwise"),
        make_plan(make_compressor("natural"), one, transport="flat"),
        make_plan(make_compressor("qsgd", levels=4), one,
                  transport="packed", narrow=True)),
        assignment=FLEET_ASSIGNMENT)
    vec = mixed.round_bits_vector()
    lines, ms = [], {}
    reset_launches()        # the fleet main path starts here
    # (a) the uniform-fleet keystone on both engines
    single = make_plan(make_compressor("qsgd", levels=4), one,
                       transport="packed", narrow=True)
    for engine, faults, xi in (("sync", None, TRAIN_XI),
                               ("async chaos", chaos_plan(), CHAOS_XI)):
        part = None if faults is None else 0.75
        ref, ms[f"{engine} single plan"], _, _ = fleet_run(
            dev, single, xi, faults=faults, participation=part, **kw)
        host = host_copy(ref.state.params)
        ledger = ref.ledger.history
        del ref
        uni, ms[f"{engine} uniform fleet"], _, _ = fleet_run(
            dev, as_fleet_plan(single, n), xi, faults=faults,
            participation=part, **kw)
        check(equal_by_value(uni.state.params, host, dev)
              and uni.ledger.history == ledger, f"fleet width {engine}: "
              "the uniform fleet differs from its single plan")
        del uni, host
    # (b) the mixed fleet
    for engine, faults, xi in (("sync", None, TRAIN_XI),
                               ("async chaos", chaos_plan(), CHAOS_XI)):
        part = None if faults is None else 0.75
        run, ms[f"{engine} mixed"], peak, got = fleet_run(
            dev, mixed, xi, faults=faults, participation=part, **kw)
        fresh = run.n_agg_comm
        mean = per_client_uplink(vec, n)
        if faults is None:
            check(run.ledger.uplink_bits_per_client * n
                  == run.ledger.rounds * sum(vec) and run.ledger.rounds == 2,
                  f"fleet width sync: ledger {run.ledger}")
            late = 0
        else:
            st = run.fault_stats
            check(st["sent"] == st["delivered"] + st["dropped"]
                  + st["evicted"] + st["rejected"], f"fleet chaos: events "
                  f"not conserved {st}")
            # each round adds (sent_r / n) * mean: the sum of the rounds'
            # products, within float64 rounding of the product of the sum
            got_bits = run.ledger.uplink_bits_per_client
            want_bits = st["sent"] / n * mean
            check(run.ledger.rounds == 5
                  and abs(got_bits - want_bits) <= 1e-12 * want_bits,
                  f"fleet chaos: ledger {run.ledger} against the fleet's "
                  f"vector ({want_bits})")
            check(st["stale"] >= 1, f"fleet chaos: no straggler {st}")
            late = chaos_late_folds(n, xi, part)
        want = {"natural_pack": fresh, "qsgd_pack": fresh,
                "natural_reduce": fresh + late, "qsgd_reduce": fresh + late}
        check(got == want, f"fleet width {engine}: launches {got}, the "
              f"path implies {want}")
        check(peak <= TRAIN_PEAK, f"fleet width {engine}: peak "
              f"{peak / 1e9:.2f} GB")
        for leaf in tree_leaves(run.state.params):
            check(bool(torch.isfinite(leaf).all()), "non-finite params")
        if faults is None:
            lines.append(fleet_plain_check(dev, mixed, run.state.params))
        lines.append(f"{engine}: {run.ledger.rounds} rounds, uplink "
                     f"{run.ledger.uplink_bits_per_client * n:.6e} bits "
                     f"in all (sum_i round_bits(i) = {sum(vec):.6e} a full "
                     f"round), peak {peak / 1e9:.2f} GB, launches {got}"
                     + ("" if faults is None else f", events "
                        f"{run.fault_stats}"))
        del run
    # (c) the controller: two adjustable QSGD cohorts and a natural one
    fleet = FleetPlan(cohorts=(
        make_plan(make_compressor("qsgd"), one, transport="flat"),
        make_plan(make_compressor("qsgd"), one, transport="packed"),
        make_plan(make_compressor("natural"), one, transport="flat")),
        assignment=FLEET_ASSIGNMENT)
    budget = 0.5 * fleet.total_round_bits()
    ctrl = BandwidthBudgetController(budget_bits_per_round=budget)
    ledger, chosen = BitsLedger(n), []
    for _ in range(3):
        fleet = ctrl.next_fleet(fleet, ledger)
        chosen.append([p.codec.levels for p in fleet.cohorts[:2]])
        run, _, _, _ = fleet_run(dev, fleet, TRAIN_XI, **kw)
        ledger.replay_xi_trace(run.xis, fleet.round_bits_vector(), 0.0)
        check(all(np.isfinite(v) for _, v in run.losses),
              "controller run losses")
        del run
    check(ledger.rounds == 6, f"controller rounds {ledger.rounds}")
    del targets
    torch.cuda.empty_cache()
    log(f"phase fleet width: {n} clients x d={WIDTH_D}, cohorts "
        f"{mixed.mix} (assignment {FLEET_ASSIGNMENT}), identity downlink, "
        f"round_bits {sorted(set(vec))}; uniform fleet == single plan by "
        f"value (sync, async chaos); " + "; ".join(lines) + "; ms a step "
        "(first-call costs included): " +
        ", ".join(f"{k} {v:.1f}" for k, v in ms.items()) +
        f"; controller (budget {budget:.6e} bits a round): levels of the "
        f"two QSGD cohorts by round {chosen}, spent "
        f"{ledger.uplink_bits_per_client * n:.6e} bits in {ledger.rounds} "
        "rounds")



# --------------------------------------------------------------------------
# checkpoint width: dense snapshots of the width cell, bit-exact resume
# --------------------------------------------------------------------------

CKPT_XI = [0, 1, 0, 1]          # a fresh round in each of the two chunks
CKPT_CHUNK = 2
SERVE_TENANTS, SERVE_CACHE, SERVE_BATCH = 4, 2, 4
SERVE_PROMPT, SERVE_GEN = 16, 16
SERVE_SEED_SCALE = 0.01         # a tenant: base + 0.01 x N(0, 1)


def mem_available():
    """(MemAvailable bytes of /proc/meminfo, free bytes of the temp
    directory, the directory)."""
    import shutil
    import tempfile
    with open("/proc/meminfo") as f:
        avail = next(int(line.split()[1]) * 1024 for line in f
                     if line.startswith("MemAvailable:"))
    tmp = tempfile.gettempdir()
    return avail, shutil.disk_usage(tmp).free, tmp


class CommitClock:
    """Seconds each save() blocked the run and each background commit
    took, from a manager's own calls; ``last`` keeps the host snapshot
    the last commit wrote."""

    def __init__(self, mgr):
        self.blocked, self.commit, self.last = [], [], None
        save, commit = mgr.save, mgr._commit

        def timed_save(*args, **kw):
            t0 = time.perf_counter()
            out = save(*args, **kw)
            self.blocked.append(time.perf_counter() - t0)
            return out

        def timed_commit(*args):
            self.last = args[1]
            t0 = time.perf_counter()
            out = commit(*args)
            self.commit.append(time.perf_counter() - t0)
            return out

        mgr.save, mgr._commit = timed_save, timed_commit


def same_run(a, b, what):
    check(a.losses == b.losses, f"{what}: losses differ")
    check(a.ledger == b.ledger, f"{what}: ledgers differ")
    check(list(a.xis) == list(b.xis), f"{what}: xi traces differ")
    check((a.n_local, a.n_agg_comm, a.n_agg_cached)
          == (b.n_local, b.n_agg_comm, b.n_agg_cached),
          f"{what}: branch counts differ")
    check(a.fault_stats == b.fault_stats, f"{what}: fault totals differ")


def phase_checkpoint_width(dev):
    """The width cell (stablelm-1.6b's tree at full width and 4 of 24
    layers, QSGD packed uplink, flat downlink) with dense snapshots at
    every chunk boundary, then resumed from the middle one: the resumed
    run equals the uninterrupted one bit for bit (params and cache
    against the host snapshot of the last boundary, which the manager
    committed; ledger, xi trace, losses, counters; the restore is the
    resume's own, timed).  The synchronous engine, then the async engine
    under the chaos plan at participation 0.5.  n from the host's
    memory: the largest of 4, 2 whose snapshot is under a quarter of
    MemAvailable and under a third of the temp directory's free space."""
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import CheckpointPolicy, resume
    from repro_torch.core import L2GDHyper, make_compressor, make_plan, prng
    from repro_torch.core.tree import tree_leaves
    from repro_torch.fl import run_l2gd
    from repro_torch.kernels.dispatch import LAUNCHES, reset_launches

    avail, free, tmp = mem_available()
    # 4 clients at most (8 before the multi-device slice): the snapshots'
    # host copies and commits took 101-140 s a run at 8
    pick = [n for n in (4, 2)
            if (n + 1) * 4 * WIDTH_D < avail / 4
            and (n + 1) * 4 * WIDTH_D < free / 3]
    check(pick, f"host memory {avail / 1e9:.1f} GB / temp space "
          f"{free / 1e9:.1f} GB hold no snapshot of 3 x {WIDTH_D} floats")
    n = pick[0]
    snap_gb = (n + 1) * 4 * WIDTH_D / 1e9
    log(f"phase checkpoint width: MemAvailable {avail / 1e9:.1f} GB, "
        f"{tmp} free {free / 1e9:.1f} GB -> n = {n} clients (dense "
        f"snapshot {snap_gb:.2f} GB)")
    seeded, targets, grad_fn = width_objective(dev, n)
    comp = make_compressor("qsgd")
    one = width_tree(1, lambda s: torch.empty(s[1:], device="meta"))
    plans = (make_plan(comp, one, transport="packed"),
             make_plan(comp, one, transport="flat"))
    hp = L2GDHyper(eta=0.5, lam=1.0, p=0.3, n=n)
    load, restores = resume.load_rollout_checkpoint, []

    def timed_load(*args, **kw):         # the driver's restore, timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = load(*args, **kw)
        torch.cuda.synchronize()
        restores.append(time.perf_counter() - t0)
        return out

    resume.load_rollout_checkpoint = timed_load
    launches = {}
    try:
        for engine, faults, part in (("sync", None, None),
                                     ("async", chaos_plan(), 0.5)):
            root = tempfile.mkdtemp(prefix="ckpt-width-")
            try:
                def run(**kw):
                    return run_l2gd(prng.PRNGKey(0), width_tree(
                        n, seeded(0, 0.02)), grad_fn, hp, lambda k: targets,
                        len(CKPT_XI), plan=plans, xi_trace=CKPT_XI,
                        chunk=CKPT_CHUNK, faults=faults, participation=part,
                        device=dev, **kw)

                policy = CheckpointPolicy(root)
                clock = CommitClock(policy.resolve())
                reset_launches()          # the main path starts here
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                base = run(checkpoint_policy=policy)
                torch.cuda.synchronize()
                base_s = time.perf_counter() - t0
                policy.resolve().close()
                steps = policy.resolve().all_steps()
                check(steps == [2, 4], f"{engine}: snapshots at {steps}")
                mid = steps[0]
                base.state = None
                # the host copy of step 4's params and cache, the rest let go
                last, clock.last = clock.last, None
                if engine == "async":
                    check(last["agg"] is not None
                          and int(last["agg"]["rnd"]) > 0,
                          "async snapshot carries no delay buffer")
                want = {"params": tree_leaves(
                            last["state"]["params"]["dense"]),
                        "cache": tree_leaves(last["state"]["cache"]),
                        "step": int(last["state"]["step"])}
                del last
                torch.cuda.empty_cache()
                t0 = time.perf_counter()
                resumed = run(resume_from=root, resume_step=mid)
                torch.cuda.synchronize()
                resume_s = time.perf_counter() - t0
                launches[engine] = dict(LAUNCHES)   # the main path ends here
                same_run(base, resumed, f"checkpoint width ({engine})")
                nbytes = {s_: sum(os.path.getsize(os.path.join(dp, f))
                                  for dp, _, fs in os.walk(os.path.join(
                                      root, f"step_{s_:010d}")) for f in fs)
                          for s_ in steps}
                for tree in ("params", "cache"):
                    got = tree_leaves(getattr(resumed.state, tree))
                    check(len(got) == len(want[tree]) and all(
                        torch.equal(a, b.to(dev))
                        for a, b in zip(got, want[tree])),
                        f"checkpoint width ({engine}): resumed {tree} differ "
                        "from the uninterrupted run's")
                check(resumed.state.step == want["step"] == len(CKPT_XI),
                      f"{engine}: step counters")
                restore_s = restores[-1]
                log(f"phase checkpoint width ({engine}"
                    + (", chaos, participation 0.5" if faults else "")
                    + f"): {n} clients x d={WIDTH_D}, snapshots at {steps}, "
                    f"{nbytes[mid] / 1e9:.2f} GB each; save() blocked "
                    f"{', '.join(f'{b:.2f}' for b in clock.blocked)} s of "
                    f"commits {', '.join(f'{c:.2f}' for c in clock.commit)} s "
                    f"(snapshot copy + pack + write + fsync); run "
                    f"{base_s:.2f} s ({len(CKPT_XI)} steps with snapshots), "
                    f"resumed from step {mid} {resume_s:.2f} s, of which the "
                    f"restore onto the card {restore_s:.2f} s = "
                    f"{nbytes[mid] / 1e9 / restore_s:.2f} GB/s; resumed == "
                    f"uninterrupted bit for bit (params, cache, "
                    f"ledger, xi, losses{', fault totals' if faults else ''})"
                    f"; launches {launches[engine]}")
                del resumed, want, base, clock
                torch.cuda.empty_cache()
            finally:
                shutil.rmtree(root, ignore_errors=True)
            check(not os.path.exists(root),
                  f"{engine}: snapshot directory {root} left behind")
    finally:
        resume.load_rollout_checkpoint = load
    del targets
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------
# serve store: stablelm-1.6b tenants from the base-plus-delta store
# --------------------------------------------------------------------------

def serve_tenants(dev, cfg, n, seed=0):
    """n tenants as seeded perturbations of one seeded base, stacked on
    the card: x_i = base + SERVE_SEED_SCALE x N(0, 1)."""
    import torch
    from repro_torch.core.tree import tree_map
    from repro_torch.models import init_params
    base = init_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                       dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def stack(a):
        out = a.unsqueeze(0).repeat((n,) + (1,) * a.dim())
        for i in range(n):
            out[i].add_(torch.randn(a.shape, generator=gen, device=dev),
                        alpha=SERVE_SEED_SCALE)
        return out

    stacked = tree_map(stack, base)
    del base
    return stacked


def plain_tenant(store, tid):
    """The tenant decoded by the plain PyTorch versions on the card (the
    QSGD unpack's plain version; the natural merge as one client of the
    plain natural reduce), added to the base as materialize does."""
    import torch
    from repro_torch.core.codec import NaturalPayload
    from repro_torch.core.flatbuf import unbucketize, unravel, widen_tree_qsgd
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels.natural.ref import natural_reduce_ref
    from repro_torch.kernels.qsgd.ref import qsgd_unpack_ref
    p = store.payload(tid)
    if isinstance(p, NaturalPayload):
        y = natural_reduce_ref(p.exps[None], p.signs[None])
    else:
        p = widen_tree_qsgd(p) if hasattr(p, "width") else p
        y = qsgd_unpack_ref(p.codes, p.norms, levels=p.levels)
    delta = unravel(p.layout, unbucketize(y, p.layout.d))
    return tree_map(lambda b, d: (b + d.to(torch.float32)).to(b.dtype),
                    store.base, delta)


def lru_trace(capacity, accesses):
    """(eviction log, hits, misses) of an LRU of ``capacity`` over the
    tenant access sequence, by hand."""
    import collections
    cache, log_, hits, misses = collections.OrderedDict(), [], 0, 0
    for tid in accesses:
        if tid in cache:
            cache.move_to_end(tid)
            hits += 1
            continue
        misses += 1
        cache[tid] = None
        while len(cache) > capacity:
            log_.append(cache.popitem(last=False)[0])
    return log_, hits, misses


def store_equal(a, b, tids):
    """Payload arrays and static fields equal, tenant by tenant."""
    import dataclasses
    import torch

    def fields(p):
        if hasattr(p, "leaves"):
            return [x for q in p.leaves for x in fields(q)]
        return [(f.name, getattr(p, f.name)) for f in dataclasses.fields(p)]

    for tid in tids:
        fa, fb = fields(a.payload(tid)), fields(b.payload(tid))
        check(len(fa) == len(fb), f"tenant {tid}: payload fields differ")
        for (na, va), (nb, vb) in zip(fa, fb):
            same = torch.equal(va, vb) if isinstance(va, torch.Tensor) \
                else va == vb
            check(na == nb and same, f"tenant {tid}: field {na} differs")


def serve_ingest_check(stacked, store, key, codec):
    """The ingest kernel against its plain version at the serve path's
    shape: tenant i's delta x_i - base, bucketized as the plan does, and
    its key words seeds_of(fold_in(key, i)) rebuilt here; the stored
    payload (narrow codes widened first) held in windows at rows 0 and
    nb - WINDOW, as phase width kernels holds the pack.  QSGD: codes
    bit-exact given the stored norms, the norms within NORM_ULPS of the
    plain sum; natural: exponents and signs bit-exact.  Returns the
    kernel's name, its largest |norm - plain norm| and a log fragment."""
    import torch
    from repro_torch.core import flatbuf, prng
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels.natural.ref import natural_pack_ref
    from repro_torch.kernels.qsgd.ref import qsgd_pack_ref

    err, norm_ulps, shape = 0.0, 0, None
    for i, tid in enumerate(store.tenants):
        p = store.payload(tid)
        if hasattr(p, "width"):
            p = flatbuf.widen_tree_qsgd(p)
        layout = p.layout
        delta = tree_map(lambda a, b: (a[i] - b).to(torch.float32),
                         stacked, store.base)
        x = flatbuf.bucketize(flatbuf.ravel(layout, delta), layout.bucket)
        del delta
        seeds = flatbuf.seeds_of(prng.fold_in(key, i))
        nb, shape = x.shape[0], tuple(x.shape)
        for r0 in (0, nb - WINDOW):
            win = slice(r0, r0 + WINDOW)
            if codec.startswith("qsgd"):
                given, _ = qsgd_pack_ref(x[win], seeds, levels=p.levels,
                                         row_offset=r0, norms=p.norms[win])
                check(torch.equal(given, p.codes[win]),
                      f"{codec}: tenant {tid}'s codes, window at {r0}, "
                      "given the stored norms")
                _, own = qsgd_pack_ref(x[win], seeds, levels=p.levels,
                                       row_offset=r0)
                norm_ulps = max(norm_ulps, ulps(own, p.norms[win]))
                err = max(err, float(torch.max(torch.abs(own
                                                         - p.norms[win]))))
            else:
                e, s = natural_pack_ref(x[win], seeds, row_offset=r0)
                check(torch.equal(e, p.exps[win])
                      and torch.equal(s, p.signs[win]),
                      f"{codec}: tenant {tid}'s exponents and signs, "
                      f"window at {r0}")
        del x
    if codec.startswith("qsgd"):
        check(norm_ulps <= NORM_ULPS, f"{codec}: stored norms {norm_ulps} "
              "ulps from the plain sum")
        return "qsgd_pack", err, (
            f"qsgd_pack levels {p.levels} at {shape}, windows at rows 0 and "
            f"{shape[0] - WINDOW} of every tenant: codes bit-exact given the "
            f"stored norms, norms within {norm_ulps} ulps (max |d| {err:.3g})")
    return "natural_pack", err, (
        f"natural_pack at {shape}, windows at rows 0 and {shape[0] - WINDOW}"
        " of every tenant: exponents and signs bit-exact")


def phase_serve_store(dev):
    """stablelm-1.6b at full width and depth (1,438,746,624 params, f32):
    4 tenants, seeded perturbations of one base, stacked on the card
    (23 GB), ingested into the DeltaModelStore under qsgd4 (QSGD levels
    7, packed, narrowed to 4-bit codes) and then natural (packed), and
    served by the ServingEngine (LRU of 2, batches of 4, 16-token prompts
    from prng.randint, 16 greedy tokens) in map mode: qsgd_pack /
    natural_pack at ingest (one launch a tenant) and qsgd_unpack at
    materialize (one a QSGD miss); each tenant's stored payload against
    the pack's plain version on its own delta and key words
    (serve_ingest_check); each tenant equal to the plain decode on the
    card; mixed-tenant logits equal solo logits bit for bit; the
    LRU against the trace; store.save -> DeltaModelStore.load equal
    (at full width when 3 x the store fits in a quarter of
    MemAvailable, else at 4 layers)."""
    import dataclasses
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels.dispatch import LAUNCHES, reset_launches
    from repro_torch.launch.serve import build_plan
    from repro_torch.serve import DeltaModelStore, Request, ServingEngine

    cfg = get_config("stablelm-1.6b")
    key = prng.PRNGKey(0)
    prompts = prng.randint(prng.fold_in(key, 3),
                           (SERVE_TENANTS, SERVE_PROMPT), 0, cfg.vocab_size)
    launches, errs = {}, {}
    for codec in ("qsgd4", "natural"):
        plan, narrow = build_plan(codec)
        stacked = serve_tenants(dev, cfg, SERVE_TENANTS)
        check(sum(a[0].numel() for a in tree_leaves(stacked))
              == STABLELM_PARAMS, "stablelm-1.6b parameter count")
        reset_launches()              # the main path starts here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        store = DeltaModelStore.from_params(stacked, plan,
                                            key=prng.fold_in(key, 1),
                                            narrow=narrow)
        torch.cuda.synchronize()
        ingest_ms = (time.perf_counter() - t0) * 1e3
        pack = "qsgd_pack" if codec.startswith("qsgd") else "natural_pack"
        check(LAUNCHES.get(pack, 0) == SERVE_TENANTS,
              f"{codec}: {pack} launched {LAUNCHES.get(pack, 0)} times at "
              f"ingest, expected one a tenant")
        ingest = dict(LAUNCHES)
        name, err, held = serve_ingest_check(stacked, store,
                                             prng.fold_in(key, 1), codec)
        check(dict(LAUNCHES) == ingest, "the plain ingest check launched "
              "a kernel")
        errs[name] = max(errs.get(name, 0.0), err)
        log(f"phase serve store ({codec}): {held}")
        del stacked
        torch.cuda.empty_cache()
        tids = store.tenants
        requests = [Request(t, tuple(int(v) for v in prompts[i]),
                            gen=SERVE_GEN) for i, t in enumerate(tids)]
        engine = ServingEngine(store, cfg, cache_capacity=SERVE_CACHE,
                               max_batch=SERVE_BATCH)
        order = [3, 2, 0, 1, 3]       # solo requests after the mixed batch
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        mixed = engine.serve(requests, return_logits=True)
        mixed_s = time.perf_counter() - t0
        solo = [engine.serve([requests[i]], return_logits=True)[0]
                for i in order]
        served = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                  if v - before.get(k, 0)}
        launches[codec] = dict(LAUNCHES)   # the main path ends here
        misses = engine.metrics.misses
        want_unpack = misses if codec.startswith("qsgd") else 0
        check(served.get("qsgd_unpack", 0) == want_unpack
              and set(served) <= {"qsgd_unpack"},
              f"{codec}: serving launched {served}, expected "
              f"{want_unpack} qsgd_unpack (one a miss)")
        want_log, hits, misses = lru_trace(
            SERVE_CACHE, tids + [tids[i] for i in order])
        check(engine.metrics.eviction_log == want_log
              and (engine.metrics.hits, engine.metrics.misses)
              == (hits, misses), f"{codec}: LRU {engine.metrics.eviction_log}"
              f" hits {engine.metrics.hits} misses "
              f"{engine.metrics.misses}, the trace gives {want_log} "
              f"{hits} {misses}")
        for r, i in zip(solo, order):
            m = mixed[i]
            check(m["tenant"] == r["tenant"] and r["batch_size"] == 1,
                  "solo request order")
            check(np.array_equal(m["logits"], r["logits"])
                  and np.array_equal(m["tokens"], r["tokens"]),
                  f"{codec}: tenant {r['tenant']} mixed logits differ from "
                  "solo")
        check(np.array_equal(solo[0]["logits"], solo[-1]["logits"]),
              f"{codec}: two solo runs of tenant {tids[3]} differ")
        check(all(np.isfinite(m["logits"]).all() for m in mixed),
              f"{codec}: non-finite logits")
        # materialize: the kernel against the plain decode on the card
        mat_ms = []
        for tid in tids:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = store.materialize(tid)
            torch.cuda.synchronize()
            mat_ms.append((time.perf_counter() - t0) * 1e3)
            want = plain_tenant(store, tid)
            check(all(torch.equal(a, b) for a, b in
                      zip(tree_leaves(got), tree_leaves(want))),
                  f"{codec}: tenant {tid} differs from the plain decode")
            del got, want
        ttft = float(np.median([r["ttft_s"] for r in mixed])) * 1e3
        per_tok = (mixed[0]["gen_time_s"] - mixed[0]["ttft_s"]) \
            / (SERVE_GEN - 1) * 1e3
        solo_tok = float(np.median([
            (r["gen_time_s"] - r["ttft_s"]) / (SERVE_GEN - 1) * 1e3
            for r in solo]))
        mpg = store.models_per_gb()
        log(f"phase serve store ({codec}): stablelm-1.6b full, "
            f"{SERVE_TENANTS} tenants; ingest {ingest_ms:.1f} ms "
            f"({ingest}); residency {mpg:.3f} models/GB = "
            f"{mpg / store.dense_models_per_gb(32.0):.3f}x dense f32, "
            f"{mpg / store.dense_models_per_gb(16.0):.3f}x dense bf16 "
            f"(by cohort {store.models_per_gb_by_cohort()}); mixed batch "
            f"of {SERVE_TENANTS} ({mixed_s:.2f} s, misses and materialize "
            f"included): TTFT {ttft:.1f} ms ({SERVE_PROMPT} prompt "
            f"tokens), {per_tok:.2f} ms a generated token for the batch; "
            f"solo {solo_tok:.2f} ms a token; materialize "
            f"{', '.join(f'{v:.1f}' for v in mat_ms)} ms; serving "
            f"launches {served}; LRU evictions {engine.metrics.eviction_log}"
            f", hits {engine.metrics.hits}, misses {engine.metrics.misses};"
            f" mixed == solo logits bit for bit, two solo runs of tenant "
            f"{tids[3]} equal, tenants == plain decode")
        del engine, mixed, solo
        torch.cuda.empty_cache()
        # persistence
        avail, free, _ = mem_available()
        nbytes = store.total_bits() / 8
        full = 3 * nbytes < avail / 4 and 2 * nbytes < free
        if not full:
            del store
            torch.cuda.empty_cache()
            small = dataclasses.replace(cfg, n_layers=4)
            stacked = serve_tenants(dev, small, SERVE_TENANTS)
            store = DeltaModelStore.from_params(
                stacked, plan, key=prng.fold_in(key, 1), narrow=narrow)
            del stacked
        root = tempfile.mkdtemp(prefix="serve-store-")
        try:
            path = os.path.join(root, "store.ckpt")
            t0 = time.perf_counter()
            store.save(path)
            save_s = time.perf_counter() - t0
            size = os.path.getsize(path)
            t0 = time.perf_counter()
            back = DeltaModelStore.load(path, device=dev)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        finally:
            shutil.rmtree(root, ignore_errors=True)
        check(back.tenants == store.tenants and back.narrow == store.narrow,
              f"{codec}: loaded store's tenants")
        store_equal(store, back, store.tenants)
        check(all(torch.equal(a, b) for a, b in zip(
            tree_leaves(back.materialize(tids[1])),
            tree_leaves(store.materialize(tids[1])))),
            f"{codec}: loaded store's tenant {tids[1]} differs")
        log(f"phase serve store ({codec}): store.save -> load at "
            + ("full width and depth" if full else
               f"4 layers (3 x {nbytes / 1e9:.2f} GB at full depth exceeds "
               f"a quarter of MemAvailable {avail / 1e9:.1f} GB)")
            + f": {size / 1e9:.3f} GB file, save {save_s:.2f} s, load onto "
            f"the card {load_s:.2f} s; payloads and a materialized tenant "
            "equal")
        del store, back
        torch.cuda.empty_cache()
    return launches, errs


# --------------------------------------------------------------------------
# the multi-device launch layer: a world of one on NCCL
# --------------------------------------------------------------------------

def bits_digest(t):
    """An exact 64-bit digest of a tensor's bits on its device: the sum
    mod 2^64 of each element's bit pattern times an odd multiplier of
    its position.  Any single differing element changes it (an odd
    number is invertible mod 2^64); two runs are compared leaf by leaf
    through it where both states do not fit the card together."""
    import torch
    words = {4: torch.int32, 2: torch.int16, 1: torch.int8}[t.element_size()]
    flat = t.detach().reshape(-1).view(words)
    mask = (1 << (8 * t.element_size())) - 1
    acc = torch.zeros((), dtype=torch.int64, device=t.device)
    for lo in range(0, flat.numel(), DIGEST_CHUNK):
        part = flat[lo:lo + DIGEST_CHUNK].to(torch.int64) & mask
        mul = torch.arange(lo, lo + part.numel(), dtype=torch.int64,
                           device=t.device).mul_(DIGEST_MUL).bitwise_or_(1)
        acc += part.mul_(mul).sum()
    return int(acc)


def state_digest(state):
    from repro_torch.core.tree import tree_leaves
    return [bits_digest(a) for a in tree_leaves((state.params, state.cache))]


def same_trace(got, want, what):
    check(list(got.xis) == list(want.xis), f"{what}: xi traces differ")
    check(list(got.branches) == list(want.branches),
          f"{what}: branches differ")
    check(torch_equal(got.losses, want.losses), f"{what}: losses differ")


def torch_equal(a, b):
    import torch
    return bool(torch.equal(a.cpu(), b.cpu()))


def phase_mesh_width(dev):
    """The width cell through the client-sharded engine on a 1-process
    NCCL client mesh against the stacked engine, packed QSGD then packed
    natural both ways; returns the sharded runs' launches."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import L2GDHyper, init_state, make_compressor
    from repro_torch.core import make_plan, prng
    from repro_torch.core.aggregation import _gather_payloads
    from repro_torch.core.collective import GATHERED, reset_gathered
    from repro_torch.core.rollout import rollout_l2gd, rollout_l2gd_sharded
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels.dispatch import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import make_client_mesh, mesh_axis

    mesh = make_client_mesh(1, device=dev)
    want = "nccl" if dev.type == "cuda" else "gloo"
    check(dist.get_backend() == want and mesh.device_type == dev.type,
          f"mesh width: backend {dist.get_backend()} on "
          f"{mesh.device_type}")
    n, xi = WIDTH_CLIENTS, np.asarray(TRAIN_XI, np.int32)
    seeded, targets, grad_fn = width_objective(dev, n)
    hp = L2GDHyper(eta=0.5, lam=1.0, p=0.3, n=n)
    one = width_tree(1, lambda s: torch.empty(s[1:], device="meta"))
    key = prng.PRNGKey(0)
    out = {}
    for name, kernels in (("qsgd", ("qsgd_pack", "qsgd_reduce")),
                          ("natural", ("natural_pack", "natural_reduce"))):
        plan = make_plan(make_compressor(name), one, transport="packed")
        kw = dict(grad_fn=grad_fn, client_comp=plan, master_comp=plan,
                  batch_axis=None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref, ref_trace = rollout_l2gd(
            key, init_state(width_tree(n, seeded(0, 0.02))), hp, targets,
            xi, **kw)
        torch.cuda.synchronize()
        stacked_s = time.perf_counter() - t0
        want = state_digest(ref)
        del ref
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_gathered()
        reset_launches()            # the sharded main path starts here
        t0 = time.perf_counter()
        got, trace = rollout_l2gd_sharded(
            key, init_state(width_tree(n, seeded(0, 0.02))), hp, targets,
            xi, mesh=mesh, **kw)
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t0
        launches = dict(LAUNCHES)   # and ends here
        gathered = dict(GATHERED)
        peak = torch.cuda.max_memory_allocated(dev)
        same_trace(trace, ref_trace, f"mesh width ({name})")
        check(state_digest(got) == want,
              f"mesh width ({name}): sharded params / cache differ from "
              "the stacked engine's")
        for k in kernels:
            check(launches.get(k, 0) > 0, f"mesh width ({name}): {k} never "
                  f"launched ({launches})")
        # the payloads' bytes, plus each step's float32 loss sum
        msg = plan.round_bits() / 8
        fresh = trace.n_agg_comm
        payload_bytes = gathered.get("bytes", 0) - 4 * len(xi)
        check(payload_bytes == fresh * n * msg,
              f"mesh width ({name}): all_gather moved {payload_bytes} "
              f"payload bytes, {fresh} rounds x {n} x {msg:.0f} expected")
        # one gather of the 8 clients' payloads, timed alone
        keys = prng.split(key, n)
        payload = plan.encode(keys, got.params)
        axis = mesh_axis(mesh, "clients")
        gather_ms = time_ms(lambda: _gather_payloads(payload, axis,
                                                     batched=True), reps=5)
        del payload, got
        torch.cuda.empty_cache()
        out[f"mesh width {name}"] = launches
        log(f"phase mesh width ({name}, packed both ways): {n} clients x "
            f"d={WIDTH_D}, a 1-process {dist.get_backend()} client mesh; "
            f"stacked "
            f"{stacked_s / 5 * 1e3:.1f} ms a step, sharded "
            f"{sharded_s / 5 * 1e3:.1f} ms a step (5 steps, xi "
            f"{TRAIN_XI}); params, cache, losses and xis equal; all_gather "
            f"{gathered.get('calls')} calls, {payload_bytes:,} payload "
            f"bytes = {fresh} rounds x {n} x {msg:,.0f} (round_bits / 8) "
            f"and {len(xi)} loss sums; "
            f"one gather of {n} payloads ({n * msg / 1e9:.3f} GB) "
            f"{gather_ms:.3f} ms; peak allocated {peak / 1e9:.2f} GB; "
            f"losses {[round(float(v), 1) for v in trace.losses]}; "
            f"launches {launches}")
    del targets
    torch.cuda.empty_cache()
    return out


def phase_mesh2d_train(dev):
    """mistral-large-123b at full width and one layer through the 2-D
    engine on a (1, 1) NCCL train mesh (remat "dots") against
    build_rollout_fn (remat "full"), a step a call; returns the 2-D
    run's launches."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import L2GDHyper, init_state, make_compressor, prng
    from repro_torch.core.rollout import window_streams
    from repro_torch.data import TokenStream
    from repro_torch.kernels.dispatch import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import make_train_mesh, model_shards_of
    from repro_torch.launch.steps import (build_rollout_fn,
                                          build_sharded_rollout_fn)
    from repro_torch.launch.train import init_stacked_params
    from repro_torch.models import param_count

    cfg = dataclasses.replace(get_config(MISTRAL_SERVE[0]), n_layers=1)
    check(cfg.attn_impl == "dense" and cfg.remat, "mesh2d train config")
    n = TRAIN_CLIENTS
    hp = L2GDHyper(eta=0.1, lam=0.5, p=0.5, n=n)
    seed = next(s for s in range(100) if list(window_streams(
        prng.PRNGKey(s), hp.p, 0, len(MESH2D_XI))[0]) == MESH2D_XI)
    key = prng.PRNGKey(seed)
    stream = TokenStream(n_clients=n, vocab=cfg.vocab_size, batch=TRAIN_B,
                         seq=TRAIN_S)
    tokens = torch.from_numpy(np.stack([stream.batch_at(k) for k in
                                        range(len(MESH2D_XI))])).to(dev)
    comp = make_compressor("natural")
    mesh = make_train_mesh(model_shards=1, device=dev)
    check(model_shards_of(mesh) == 1, "a (1, 1) train mesh")
    runs = {
        "build_rollout_fn (full)": build_rollout_fn(
            dataclasses.replace(cfg, remat_policy="full"), hp, comp, comp,
            length=1),
        "mesh2d (dots)": build_sharded_rollout_fn(
            dataclasses.replace(cfg, remat_policy="dots"), hp, mesh=mesh,
            client_comp=comp, master_comp=comp, length=1)}
    results, launches = {}, {}
    for what, rollout in runs.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        state = init_state(init_stacked_params(cfg, n, 0, dev))
        check(param_count(state.params) == n * MISTRAL_TRAIN_PARAMS,
              "mistral 1-layer parameter count")
        init_peak = torch.cuda.max_memory_allocated(dev)
        reset_launches()        # the run's path starts here
        seconds, losses, branches, peaks = [], [], [], []
        for k in range(len(MESH2D_XI)):
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            state, trace = rollout(state, {"tokens": tokens[k:k + 1]}, key)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated(dev))
            losses.append(trace.losses.cpu())
            branches.append(int(trace.branches[0]))
        launches[what] = dict(LAUNCHES)     # and ends here
        peak = max([init_peak] + peaks)
        check(branches == [2, 0, 1, 2], f"{what}: branches {branches}")
        check(peak <= TRAIN_PEAK, f"{what}: peak {peak / 1e9:.2f} GB")
        losses = torch.cat(losses)
        check(bool(torch.isfinite(losses).all()), f"{what}: losses")
        results[what] = (state_digest(state), losses)
        del state, trace
        log(f"phase mistral mesh2d train, {what}: mistral-large-123b 1 "
            f"layer, {n} clients x {MISTRAL_TRAIN_PARAMS:,} params, "
            f"B={TRAIN_B} S={TRAIN_S}, leafwise natural; step seconds "
            f"{[round(t, 3) for t in seconds]} (cached, local, fresh, "
            f"cached); losses {[float(v) for v in losses]}; peak allocated "
            f"{peak / 1e9:.2f} GB (a step: "
            f"{[round(b / 1e9, 2) for b in peaks]}); launches "
            f"{launches[what]}")
    (ref, ref_losses), (got, got_losses) = results.values()
    check(torch.equal(ref_losses, got_losses), "mesh2d losses differ")
    check(got == ref, "mesh2d params / cache differ from build_rollout_fn's")
    # one fresh round, 11 leaves, two links: a draw and a kernel each
    want = {"natural_compress_2d": 2 * 11, DRAW_KERNEL: 2 * 11}
    for what, got_launches in launches.items():
        check(got_launches == want, f"{what}: launches {got_launches}")
    torch.cuda.empty_cache()
    log("phase mistral mesh2d train: the (1, 1) mesh with remat 'dots' "
        "equals build_rollout_fn with remat 'full' bit for bit (params, "
        "cache, losses, xis)")
    return launches["mesh2d (dots)"]


def shards_cfg(arch, layers):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    check(cfg.remat and cfg.attn_impl == "dense", "mesh2d shards config")
    return cfg


def shards_steps(rollout, state, tokens, key, dev):
    """A step a call of a built rollout over ``tokens`` (steps, n, B, S):
    (state, seconds, losses, branches, each step's peak allocated, each
    step's GATHERED and REDUCED counts)."""
    import torch
    from repro_torch.core.collective import (GATHERED, REDUCED,
                                             reset_gathered, reset_reduced)
    seconds, losses, branches, peaks, counts = [], [], [], [], []
    for k in range(tokens.shape[0]):
        torch.cuda.reset_peak_memory_stats(dev)
        reset_gathered()
        reset_reduced()
        t0 = time.perf_counter()
        state, trace = rollout(state, {"tokens": tokens[k:k + 1]}, key)
        torch.cuda.synchronize(dev)
        seconds.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated(dev))
        losses.append(float(trace.losses[0]))
        branches.append(int(trace.branches[0]))
        counts.append({"gathered": dict(GATHERED), "reduced": dict(REDUCED)})
    return state, seconds, losses, branches, peaks, counts


def shards_against(mesh, cfg, state, ref_dir, dev):
    """This rank's blocks of the final state against the one-process
    run's leaves saved under ``ref_dir``: elements outside SHARDS_RTOL /
    SHARDS_ATOL, the largest |d| / (atol + rtol |want|), and the digests
    of the leaves the model axis leaves whole (to be held equal across
    the ranks)."""
    import torch
    from repro_torch.core.tree import spec_leaves, tree_leaves
    from repro_torch.launch.sharding import local_slice, train_state_pspecs
    from repro_torch.launch.steps import state_specs
    specs = train_state_pspecs(state_specs(cfg, TRAIN_CLIENTS), SHARDS_RANKS)
    outside, worst, replicated = 0, 0.0, []
    for i, (got, spec) in enumerate(zip(
            tree_leaves([state.params, state.cache]),
            spec_leaves([specs.params, specs.cache]))):
        ref = np.load(os.path.join(ref_dir, f"{i}.npy"), mmap_mode="r")
        want = torch.from_numpy(np.array(local_slice(mesh, spec, ref))
                                ).to(dev)
        check(want.shape == got.shape, f"leaf {i}: block {tuple(got.shape)} "
              f"against {tuple(want.shape)}")
        tol = SHARDS_ATOL + SHARDS_RTOL * want.abs()
        outside += int((~((got - want).abs() <= tol)).sum())
        worst = max(worst, float(((got - want).abs() / tol).max()))
        if "model" not in spec:
            replicated.append(bits_digest(got))
        del want, tol
    return {"outside": outside, "worst": worst, "replicated": replicated}


def mesh2d_shards_rank(rank, world, dev, runs, ref_dir):
    """The model shards of phase mesh2d shards, in a process of their own
    (``launch.mesh.run_cpu_ranks`` opened the gloo group).  For each run
    (phase, arch, layers, gather_layers, tokens, seed): this rank's blocks
    of the clients' params drawn a client at a time, the 2-D engine's
    steps (the split, or each layer gathered whole with
    ``gather_layers``), then the gathered state's digest (the gather) or
    this rank's blocks against the one-process run's saved leaves."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import L2GDHyper, init_state, make_compressor, prng
    from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten
    from repro_torch.kernels.dispatch import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import make_train_mesh, model_shards_of
    from repro_torch.launch.sharding import param_pspecs, tree_local
    from repro_torch.launch.steps import (build_sharded_rollout_fn,
                                          stacked_param_shapes)
    from repro_torch.models import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(dev)
    torch.cuda.set_device(dev)
    n = TRAIN_CLIENTS
    mesh = make_train_mesh(model_shards=world, device=dev)
    check(dist.get_backend() == "gloo" and model_shards_of(mesh) == world
          and mesh.device_type == dev.type,
          f"mesh2d shards: {dist.get_backend()} mesh on {mesh.device_type}")
    out = {}
    for what, arch, layers, gather, tokens_np, seed in runs:
        cfg = shards_cfg(arch, layers)
        specs = param_pspecs(stacked_param_shapes(cfg, n), world,
                             client_axes=("clients",))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        blocks = None
        for i in range(n):  # init_stacked_params' draws, cut a client a time
            gen = torch.Generator(device=dev).manual_seed(i)
            one = tree_local(mesh, specs, tree_map(
                lambda a: a[None], init_params(gen, cfg, dev)))
            leaves, treedef = tree_flatten(one)
            if blocks is None:
                blocks = [torch.empty((n,) + tuple(a.shape[1:]),
                                      dtype=a.dtype, device=dev)
                          for a in leaves]
            for dst, a in zip(blocks, leaves):
                dst[i].copy_(a[0])
            del one, leaves
        state = init_state(tree_unflatten(treedef, blocks))
        del blocks
        init_peak = torch.cuda.max_memory_allocated(dev)
        hp = L2GDHyper(eta=0.1, lam=0.5, p=0.5, n=n)
        comp = make_compressor("natural")
        rollout = build_sharded_rollout_fn(
            cfg, hp, mesh=mesh, client_comp=comp, master_comp=comp,
            length=1, gather_layers=gather)
        tokens = torch.from_numpy(tokens_np).to(dev)
        reset_launches()            # the main path starts here
        state, seconds, losses, branches, peaks, counts = shards_steps(
            rollout, state, tokens, prng.PRNGKey(seed), dev)
        launches = dict(LAUNCHES)   # and ends here
        res = {"losses": losses, "branches": branches, "seconds": seconds,
               "peaks": peaks, "init_peak": init_peak, "counts": counts,
               "launches": launches,
               "gather_peak": max(c["gathered"].get("peak", 0)
                                  for c in counts),
               "local_bytes": sum(a.numel() * a.element_size() for a in
                                  tree_flatten((state.params,
                                                state.cache))[0])}
        if cfg.mixer in ("mamba", "hybrid"):
            res["channels"] = int(state.params["layers"][
                "mixer" if cfg.mixer == "mamba" else "mamba"]["A_log"]
                .shape[-2])
        t0 = time.perf_counter()
        if gather:
            res["digest"] = state_digest(rollout.full_state(state))
        else:
            res.update(shards_against(mesh, cfg, state,
                                      os.path.join(ref_dir, what), dev))
        res["check_s"] = time.perf_counter() - t0
        out[what] = res
        del state, rollout, tokens
    return out


def gb(values):
    return [round(v / 1e9, 2) for v in values]


def shards_gather_peak(cfg, n, world):
    """The most bytes whole at once that the gather engine allows a
    rank: a step's largest layer of one client or the tied table
    (gathered inside the layer loop), or the n clients' largest leaf
    piece in the aggregation (a layer of a stack's leaf; natural takes
    any offset), of the leaves cut on "model"."""
    from repro_torch.core.tree import spec_leaves, tree_leaves
    from repro_torch.launch.sharding import param_pspecs
    from repro_torch.launch.steps import param_shapes
    from repro_torch.models.model import layer_stacks
    shapes = param_shapes(cfg)
    specs = param_pspecs(shapes, world, client_axes=())
    stacks = layer_stacks(cfg)
    whole, piece = {}, 0
    for key in shapes:
        for a, s in zip(tree_leaves(shapes[key]), spec_leaves(specs[key])):
            if "model" not in s:
                continue
            per = a.numel() * a.element_size() // (
                a.shape[0] if key in stacks else 1)
            whole[key] = whole.get(key, 0) + per
            piece = max(piece, per)
    return max(max(whole.values()), n * piece)


def split_gathered_bytes(cfg, world):
    """Bytes of the leaves one layer's forward gathers whole under the
    split (``launch.steps.split_gathers``), summed over the layers."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.steps import param_shapes, split_gathers
    shapes, gathers = param_shapes(cfg), split_gathers(cfg, world)
    return sum(a.numel() * a.element_size() for key in shapes
               for a, g in zip(tree_leaves(shapes[key]),
                               tree_leaves(gathers[key])) if g)


def shards_flip_bound(n, n_params):
    """The most elements of the params and cache outside SHARDS_RTOL /
    SHARDS_ATOL that SHARDS_FLIP_RATE allows after one fresh round: the
    n uplinks and the downlink compress (n + 1) x n_params elements, a
    flipped rounding moves at most the n clients' and the cache's
    element, and the flips are bounded by a Poisson mean and five of its
    standard deviations."""
    mean = SHARDS_FLIP_RATE * (n + 1) * n_params
    return (n + 1) * (mean + 5 * mean ** 0.5)


def scan_split_width(dev, E):
    """The scan kernel with its state checkpoints and its backward at the
    split's train shape (B = 1, L = 4096, E channels a rank): each
    against its plain version, timed against its bound and the plain
    version's time."""
    import torch
    from repro_torch.kernels.selective_scan import kernel as sk
    from repro_torch.kernels.selective_scan.ref import (
        selective_scan_bwd_ref, selective_scan_ref)
    B, L, N = TRAIN_B, TRAIN_S, 16
    chunk = sk.ckpt_chunk(N)
    gen = torch.Generator(device=dev).manual_seed(6)
    dt, Bm, Cm, x, A = scan_inputs(gen, B, L, E, N, dev)
    g = torch.randn((B, L, E), generator=gen, device=dev)
    y, h = sk._launch(dt, Bm, Cm, x, A, ckpt=True)
    fwd_ms = time_ms(lambda: sk._launch(dt, Bm, Cm, x, A, ckpt=True),
                     reps=25)
    plain, plain_s = timed(lambda: selective_scan_ref(dt, Bm, Cm, x, A))
    err = float(torch.max(torch.abs(y - plain)))
    check(err <= scan_bound(plain), f"selective_scan at E={E}: {err:.3g}")
    got = sk._launch_bwd(dt, Bm, Cm, x, A, h, g)
    bwd_ms = time_ms(lambda: sk._launch_bwd(dt, Bm, Cm, x, A, h, g),
                     reps=25)
    want, bwd_plain_s = timed(lambda: selective_scan_bwd_ref(
        dt, Bm, Cm, x, A, h, g, chunk))
    rel, bwd_err = scan_bwd_compare(f"selective_scan_bwd at E={E}", got,
                                    want)
    fwd_bound = max(scan_bound_ms(B, L, E, N, 4))
    bwd_bound = max(scan_bwd_bound_ms(B, L, E, N, chunk))
    log(f"time selective_scan at the split (B={B} L={L} E={E} N={N} f32, "
        f"with checkpoints): {fwd_ms:.3f} ms (bound {fwd_bound:.3f} ms, "
        f"{fwd_bound / fwd_ms:.0%}); plain {plain_s * 1e3:.1f} ms; max |d| "
        f"{err:.3g}; selective_scan_bwd: {bwd_ms:.3f} ms (bound "
        f"{bwd_bound:.3f} ms, {bwd_bound / bwd_ms:.0%}; plan "
        f"{sk.bwd_plan(B, E, N, sk.bwd_slots(dev, N))}); plain "
        f"{bwd_plain_s * 1e3:.1f} ms; within {rel:.3g} x max |plain| (max "
        f"|d| {bwd_err:.3g})")
    del dt, Bm, Cm, x, A, g, y, h, got, want, plain
    torch.cuda.empty_cache()


def phase_mesh2d_shards(dev):
    """The 2-D engine on a (1, 2) train mesh, the two model shards two
    processes on this card in one gloo group, each run of SHARDS_RUNS
    against build_rollout_fn in this process at the same shape and
    trace: stablelm-1.6b's split (SHARDS_LAYERS layers) and hymba-1.5b's
    (HYMBA_SPLIT_LAYERS; its attention gathered, the scan kernels on
    each rank's d_inner block) within SHARDS_RTOL / SHARDS_ATOL outside
    the counted flips, the leaves the model axis leaves whole equal
    across the ranks; the gather engine (``gather_layers``) bit
    for bit.  Returns each run's launches, the two ranks' summed."""
    import tempfile
    import torch
    from repro_torch.core import L2GDHyper, init_state, make_compressor, prng
    from repro_torch.core.rollout import window_streams
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import TokenStream
    from repro_torch.launch.mesh import run_cpu_ranks
    from repro_torch.launch.steps import build_rollout_fn
    from repro_torch.launch.train import init_stacked_params
    from repro_torch.models import param_count

    n = TRAIN_CLIENTS
    hp = L2GDHyper(eta=0.1, lam=0.5, p=0.5, n=n)
    seed = next(s for s in range(100) if list(window_streams(
        prng.PRNGKey(s), hp.p, 0, len(SHARDS_XI))[0]) == SHARDS_XI)
    comp = make_compressor("natural")
    runs, refs = [], {}
    with tempfile.TemporaryDirectory(prefix="shards-ref-") as ref_dir:
        for what, arch, layers, gather in SHARDS_RUNS:
            cfg = shards_cfg(arch, layers)
            stream = TokenStream(n_clients=n, vocab=cfg.vocab_size,
                                 batch=TRAIN_B, seq=TRAIN_S)
            tokens_np = np.stack([stream.batch_at(k)
                                  for k in range(len(SHARDS_XI))])
            torch.cuda.empty_cache()
            state = init_state(init_stacked_params(cfg, n, 0, dev))
            n_params = param_count(state.params) // n
            state, ref_s, ref_losses, ref_branches, ref_peaks, _ = \
                shards_steps(build_rollout_fn(cfg, hp, comp, comp, length=1),
                             state, torch.from_numpy(tokens_np).to(dev),
                             prng.PRNGKey(seed), dev)
            check(ref_branches == [0, 1],
                  f"{what}: branches {ref_branches}")
            refs[what] = {"seconds": ref_s, "losses": ref_losses,
                          "peaks": ref_peaks, "n_params": n_params,
                          "cfg": cfg}
            if gather:
                refs[what]["digest"] = state_digest(state)
            else:
                os.makedirs(os.path.join(ref_dir, what))
                for i, a in enumerate(tree_leaves([state.params,
                                                   state.cache])):
                    np.save(os.path.join(ref_dir, what, f"{i}.npy"),
                            a.cpu().numpy())
            del state
            torch.cuda.empty_cache()
            runs.append((what, arch, layers, gather, tokens_np, seed))
        t0 = time.perf_counter()
        ranks = run_cpu_ranks(mesh2d_shards_rank, SHARDS_RANKS, str(dev),
                              runs, ref_dir)
        ranks_s = time.perf_counter() - t0
    out = {}
    for what, arch, layers, gather in SHARDS_RUNS:
        ref = refs[what]
        cfg = ref["cfg"]
        got = [r[what] for r in ranks]
        for r, res in enumerate(got):
            tag = f"{what}, rank {r}"
            check(res["branches"] == [0, 1], f"{tag}: branches")
            check(max(res["peaks"]) < max(ref["peaks"]),
                  f"{tag}: peak {max(res['peaks']) / 1e9:.2f} GB, the "
                  f"one-process run's {max(ref['peaks']) / 1e9:.2f} GB")
            check(res["launches"].get("natural_compress_2d", 0) > 0,
                  f"{tag}: launches {res['launches']}")
            if gather:
                check(res["losses"] == ref["losses"],
                      f"{tag}: losses {res['losses']} against "
                      f"{ref['losses']}")
                check(res["digest"] == ref["digest"], f"{tag}: the "
                      "gathered params / cache differ from "
                      "build_rollout_fn's")
                check(res["gather_peak"] == shards_gather_peak(
                    cfg, n, SHARDS_RANKS), f"{tag}: {res['gather_peak']} "
                    "bytes whole at once")
            else:
                check(bool(np.all(np.isclose(res["losses"], ref["losses"],
                                             rtol=SHARDS_RTOL,
                                             atol=SHARDS_ATOL))),
                      f"{tag}: losses {res['losses']} against "
                      f"{ref['losses']}")
                # the local step gathers only the leaves off whole heads,
                # once a forward (and again in the remat's recompute)
                local = res["counts"][0]["gathered"].get("bytes", 0)
                per = n * split_gathered_bytes(cfg, SHARDS_RANKS)
                check(local in (per, 2 * per),
                      f"{tag}: the local step gathered {local} bytes, "
                      f"not {per} a forward")
            log(f"phase {what}, rank {r}: step seconds "
                f"{[round(t, 3) for t in res['seconds']]} (local, fresh); "
                f"peak allocated {gb(res['peaks'])} GB a step (init "
                f"{res['init_peak'] / 1e9:.2f} GB; state blocks "
                f"{res['local_bytes'] / 1e9:.2f} GB); a step's gathers "
                + ", ".join(f"{c['gathered'].get('calls', 0)} / "
                            f"{c['gathered'].get('bytes', 0) / 1e9:.3f} GB"
                            for c in res["counts"])
                + "; reduces " + ", ".join(
                    f"{c['reduced'].get('calls', 0)} / "
                    f"{c['reduced'].get('bytes', 0) / 1e9:.3f} GB"
                    for c in res["counts"])
                + f" (local, fresh); most whole at once "
                f"{res['gather_peak'] / 1e9:.3f} GB; "
                + (f"{res['channels']} channels a scan; "
                   if "channels" in res else "")
                + (f"against the one process: {res['outside']} elements "
                   f"outside rtol {SHARDS_RTOL} / atol {SHARDS_ATOL}, "
                   f"the largest difference {res['worst']:.3g} of it; "
                   if not gather else "")
                + f"check {res['check_s']:.1f} s; launches "
                f"{res['launches']}")
        if not gather:
            flips = sum(res["outside"] for res in got)
            bound = shards_flip_bound(n, ref["n_params"])
            check(flips <= bound, f"{what}: {flips} elements outside the "
                  f"tolerance, more than the flip bound {bound:.0f}")
            check(got[0]["replicated"] == got[1]["replicated"],
                  f"{what}: the ranks' replicated leaves differ")
        launches = {}
        for res in got:
            for k, v in res["launches"].items():
                launches[k] = launches.get(k, 0) + v
        out[what] = launches
        log(f"phase {what}: {arch} {layers} layers, {n} clients x "
            f"{ref['n_params']:,} params, B={TRAIN_B} S={TRAIN_S}, leafwise "
            f"natural, xi {SHARDS_XI}; {SHARDS_RANKS} gloo processes on one "
            f"card against build_rollout_fn in one process "
            + ("bit for bit (params and cache by the digest, losses "
               f"{ref['losses']})" if gather else
               f"(losses {got[0]['losses']} against {ref['losses']}; "
               f"{sum(res['outside'] for res in got)} elements outside "
               f"the tolerance, bound "
               f"{shards_flip_bound(n, ref['n_params']):.0f}; replicated "
               f"leaves equal across the ranks)")
            + f"; one process: step seconds "
            f"{[round(t, 3) for t in ref['seconds']]}, peak allocated "
            f"{gb(ref['peaks'])} GB a step; ranks' peaks "
            f"{[max(gb(res['peaks'])) for res in got]} GB; launches "
            f"{launches}")
    log(f"phase mesh2d shards: the ranks' {len(SHARDS_RUNS)} runs took "
        f"{ranks_s:.1f} s with their start")
    for k in ("selective_scan", "selective_scan_bwd"):
        check(out["hymba split"].get(k, 0) > 0,
              f"hymba split: {k} launches {out['hymba split']}")
    channels = {res["hymba split"]["channels"] for res in ranks}
    check(channels == {shards_cfg("hymba-1.5b", 1).d_inner // SHARDS_RANKS},
          f"hymba split: {channels} channels a rank")
    scan_split_width(dev, channels.pop())
    return out


def _key_paths(tree, path=""):
    """The nested dict ``tree`` with each leaf replaced by its key path."""
    if isinstance(tree, dict):
        return {key: _key_paths(val, f"{path}.{key}" if path else key)
                for key, val in tree.items()}
    return path


def add_launches(rows, by_path):
    """Add the launches of the later slices' paths (checkpoint width:
    both engines; serve store: both codecs; whisper and internvl: their
    prefill and train runs) to the kernel rows'."""
    for row in rows:
        row["launches"] += sum(counts.get(row["name"], 0)
                               for counts in by_path.values())


def frontend_train(dev, arch, layers, name, norm_ulps):
    """The train phase for a frontend model (the local step profiled),
    then its codec's kernel on its largest leaf; returns the train run's
    launches."""
    import torch
    params, launches = phase_train(dev, name, arch, layers, profile="local")
    phase_train_width(dev, arch, params, launches, name, norm_ulps)
    del params
    torch.cuda.empty_cache()
    return launches


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

    laps, mark = {}, [t0]

    def lap(what):
        """Log the seconds since the last lap (the phases' own times)."""
        now = time.perf_counter()
        laps[what], mark[0] = now - mark[0], now
        log(f"lap {what}: {laps[what]:.1f} s")

    lap("build")
    worst = phase_kernels_small(dev)
    phase_natural_kernels_small(dev)
    phase_paper(dev)
    phase_paper_natural(dev)
    phase_leafwise(dev)
    lap("kernels, paper, leafwise")
    x, launches = phase_width(dev)
    rows = phase_width_kernels(x, launches, worst)
    del x
    torch.cuda.empty_cache()
    x, launches = phase_width_natural(dev)
    rows += phase_width_kernels_natural(x, launches)
    del x
    torch.cuda.empty_cache()
    lap("width")
    phase_flash_small(dev)
    lap("flash small")
    cfg, params, tokens, launches = phase_prefill(dev)
    phase_serve(dev, cfg, params, tokens)
    del params
    torch.cuda.empty_cache()
    rows.append(phase_flash_width(dev, launches))
    lap("prefill, serve, flash width")
    phase_scan_small(dev)
    phase_scan_bwd_small(dev)
    lap("scan small, backward small")
    prefill_launches = {}
    for arch in MAMBA_PARAMS:
        cfg, params, tokens, prefill_launches[arch] = \
            phase_mamba_prefill(dev, arch)
        phase_serve(dev, cfg, params, tokens)
        del params
        torch.cuda.empty_cache()
    rows.append(phase_scan_width(dev, prefill_launches["falcon-mamba-7b"]))
    lap("mamba prefill, serve, scan width")
    norm_ulps = phase_dequantize_small(dev)
    # the QSGD run's fresh step would repeat the natural run's profile
    # (the same draws: 82.4% against 82.6%) at ~40 s of the profiler's pass
    for name, profile in (("natural", True), ("qsgd", "local")):
        params, launches = phase_train(dev, name, profile=profile)
        rows.append(phase_train_width(dev, "stablelm-1.6b", params,
                                      launches, name, norm_ulps))
        del params
        torch.cuda.empty_cache()
        if name == "natural":
            rows.append(phase_threefry_width(dev, launches))
    lap("dequantize, train, train width, threefry width")
    train_launches = {}
    for arch, layers, name in MAMBA_TRAIN:
        params, train_launches[arch] = phase_train(dev, name, arch, layers)
        del params
        torch.cuda.empty_cache()
    rows.append(phase_scan_bwd_width(dev, train_launches["hymba-1.5b"]))
    lap("train (Mamba), scan backward width")
    phase_model_grad(dev)
    lap("model grad")
    phase_paper_fedavg(dev)
    lap("paper fedavg")
    phase_fedavg_lm(dev)
    lap("fedavg lm")
    phase_async_width(dev)
    lap("async width")
    for arch, layers in MOE_SERVE:
        cfg, params, tokens, _ = phase_moe_prefill(dev, arch, layers)
        phase_moe_serve(dev, cfg, params, tokens)
        del params
        torch.cuda.empty_cache()
    phase_route_seeds(dev)
    lap("moe prefill, serve, route seeds")
    for arch, layers, name, profile in MOE_TRAIN:
        params, launches = phase_train(dev, name, arch, layers, profile)
        phase_train_width(dev, arch, params, launches, name, norm_ulps)
        del params
        torch.cuda.empty_cache()
    phase_moe_grad(dev)
    lap("train (MoE), moe grad")
    phase_fleet_width(dev)
    lap("fleet width")
    slice_launches = phase_checkpoint_width(dev)
    lap("checkpoint width")
    serve_launches, serve_errs = phase_serve_store(dev)
    slice_launches.update(serve_launches)
    lap("serve store")
    cfg, params, tokens, frames = phase_whisper_prefill(dev)
    phase_serve(dev, cfg, params, tokens, frames=frames)
    del params, frames
    torch.cuda.empty_cache()
    lap("whisper prefill, serve")
    slice_launches["whisper train"] = frontend_train(
        dev, *FRONTEND_TRAIN[0], norm_ulps)
    lap("whisper train")
    cfg, params, tokens, slice_launches["internvl prefill"] = phase_prefill(
        dev, *INTERNVL_SERVE)
    phase_serve(dev, cfg, params, tokens)
    del params
    torch.cuda.empty_cache()
    lap("internvl prefill, serve")
    slice_launches["internvl train"] = frontend_train(
        dev, *FRONTEND_TRAIN[1], norm_ulps)
    lap("internvl train")
    slice_launches.update(phase_mesh_width(dev))
    lap("mesh width")
    cfg, params, tokens, slice_launches["mistral prefill"] = phase_prefill(
        dev, *MISTRAL_SERVE)
    phase_serve(dev, cfg, params, tokens)
    del params
    torch.cuda.empty_cache()
    lap("mistral prefill, serve")
    slice_launches["mistral mesh2d train"] = phase_mesh2d_train(dev)
    lap("mistral mesh2d train")
    slice_launches.update(phase_mesh2d_shards(dev))
    lap("mesh2d shards, hymba split")
    import torch.distributed as dist
    dist.destroy_process_group()
    add_launches(rows, slice_launches)
    for row in rows:        # the ingest kernels' check at the serve shape
        row["max_abs_err"] = max(row["max_abs_err"],
                                 serve_errs.get(row["name"], 0.0))
    log(f"total: {time.perf_counter() - t0:.1f} s; laps "
        + ", ".join(f"{k} {v:.1f}" for k, v in laps.items()))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
