// Mamba selective scan (S6), forward and backward, for Hopper (sm_90a).
// Plain C interface, loaded with ctypes by repro_torch/kernels/
// selective_scan/kernel.py.
//
// The forward replaces the Pallas TPU kernel of the JAX package:
//   selective_scan <- repro/kernels/selective_scan/kernel.py
//                     selective_scan (_scan_kernel)
// The backward (selective_scan_bwd, below the forward) has no TPU
// kernel to replace: the reference trains through XLA's autodiff of its
// chunked scan (repro/models/mamba.py selective_scan_chunked).
// It computes what _scan_kernel computes, in the same order: for each
// channel (b, e) and state n < N, from h = 0,
//   decay = exp(dt_t * A[e, n]), drive = (dt_t * x_t) * B_t[n],
//   h = decay * h + drive,        y_t = sum over n of h * C_t[n]
// with every product and sum rounded on its own (the library is built
// with --fmad=false) and the accurate expf, not __expf: the plain
// version in ref.py rounds the same way, so the state agrees with it bit
// for bit where the two exps agree and y differs only in the order of
// the N-term sum.  Inputs are float32 or bfloat16 (widened on load), A
// is float32, the state is float32, y is rounded once to the input type.
//
// Bound: at the falcon-mamba-7b prefill shape (B = 2, L = 4096,
// E = 8192, N = 16) dt, x and y are 268 MB each (0.24 ms at 3.35 TB/s),
// and the 1.07e9 state updates take one exp each on the special-function
// units (16 per SM and clock: 0.26 ms) plus about six float32 operations
// (0.10 ms at 67 TFLOP/s).  The exps and the bytes bound it about
// equally.
//
// Design:
//   * A channel's states are spread over a group of LANES lanes of one
//     warp, SPL = ceil(N / LANES) consecutive states a lane (lane j holds
//     n = j SPL .. j SPL + SPL - 1; states past N stay zero).  LANES is
//     kLanes or the power of two at or above N if that is smaller.
//     kLanes = 8 was chosen by measurement (tools/probe_kernels.py, H100
//     80GB HBM3 at 700 W): at the falcon shape 8 lanes ran 0.99 ms, 4
//     lanes 1.14 and 16 lanes 1.75 (at 16 a lane's fixed work a step,
//     the loads of dt and x and its share of the sum, serves one state;
//     at 4 a quarter of the warps hide the latency); at hymba's 0.36,
//     0.86 and 0.50.  So at N = 16 a warp runs 4 channels, two
//     states a lane: B E / 4 warps in all (4096 at the falcon shape, 31
//     an SM; 800 at hymba's E = 1600, 6 an SM), 8x the
//     one-thread-a-channel design's.  Each lane walks t = 0 ..
//     L-1 in order with its states and A[e, n] in registers: the
//     recurrence of a state is the plain version's, rounding for
//     rounding.  The TPU kernel carried the state in VMEM across a
//     sequential grid axis of chunks; Hopper runs blocks in no order, so
//     the time loop is inside the lane.
//   * y's N-term sum has a fixed order: a lane adds its SPL terms in
//     order, then the LANES partial sums meet in an xor tree (offsets
//     LANES/2, ..., 1).  The tree is taken LANES steps at a time as a
//     transposing reduction: each lane keeps LANES partials (one a step),
//     and at offset o it sends the half its partner needs, so after log2
//     LANES rounds lane j holds y of step j of the group.  That is
//     LANES - 1 shuffles for LANES steps instead of log2 LANES a step,
//     and every y is the same tree: ((p0 + p4) + (p2 + p6)) + ((p1 + p5)
//     + (p3 + p7)) at LANES = 8, where p_j = h_2j C_2j + h_2j+1 C_2j+1.
//   * A block is 128 threads: CPB = 128 / LANES consecutive channels of
//     one batch row (grid (ceil(E / CPB), B)).  Per chunk of CHUNK time
//     steps it stages the chunk's dt and x of its channels (shared by the
//     lanes of a channel) and the chunk's B_t and C_t rows (shared by the
//     block) in shared memory, and gathers y there, to write it out a
//     row of CPB channels at a time.  The next chunk's loads are issued
//     into registers before this chunk's steps run, so that their
//     latency hides behind the recurrence.
//   * Ragged edges: any L >= 1, E >= 1, N in 1..16.  Channels past E and
//     steps past L are staged as zeros (dt = 0: decay = 1, drive = 0,
//     the state does not move) and store nothing.  No padding exists in
//     device memory.
//   * Checkpoints (float32 only, for the backward): given h_ckpt, the
//     kernel also writes the state at the start of every chunk, h before
//     step k CHUNK, as h_ckpt (B, ceil(L / CHUNK), E, N).  A null h_ckpt
//     launches the instantiation without the store (the inference path's
//     code is unchanged).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 8;           // lanes a channel (at most)
constexpr int kMaxState = 16;       // the largest N the kernel takes (a
                                    // template parameter: states in
                                    // registers)
static_assert(kLanes == 1 || kLanes == 2 || kLanes == 4 || kLanes == 8 ||
                  kLanes == 16, "lanes a channel: a power of two <= 16");

constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

template <int N>
struct Split {
  static constexpr int LANES = pow2_at_least(N) < kLanes ? pow2_at_least(N)
                                                         : kLanes;
  static constexpr int SPL = (N + LANES - 1) / LANES;  // states a lane
  static constexpr int NP = LANES * SPL;               // N padded
  static constexpr int CPB = kThreads / LANES;         // channels a block
  static constexpr int CHUNK = 2048 / CPB < 32 ? 2048 / CPB : 32;
  static_assert(CHUNK % LANES == 0, "a chunk holds whole lane groups");
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// v[u] is this lane's partial sum of step u of a group; returns the xor
// tree's total of step j (this lane's index in its group of LANES)
template <int LANES>
__device__ __forceinline__ float transpose_sum(float (&v)[LANES], int j) {
#pragma unroll
  for (int o = LANES / 2; o >= 1; o /= 2) {
    const bool upper = j & o;
#pragma unroll
    for (int u = 0; u < o; ++u) {
      const float send = upper ? v[u] : v[u + o];
      const float keep = upper ? v[u + o] : v[u];
      v[u] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, o));
    }
  }
  return v[0];
}

template <typename T, int N, bool CKPT>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const T* __restrict__ dt, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const T* __restrict__ x,
                const float* __restrict__ A, T* __restrict__ y,
                float* __restrict__ h_ckpt, int L, int E) {
  using P = Split<N>;
  constexpr int LANES = P::LANES, SPL = P::SPL, NP = P::NP, CPB = P::CPB;
  constexpr int CHUNK = P::CHUNK;
  __shared__ float s_dt[CHUNK][CPB];
  __shared__ float s_x[CHUNK][CPB];
  __shared__ float s_b[CHUNK][NP];
  __shared__ float s_c[CHUNK][NP];
  __shared__ float s_y[CHUNK][CPB + 1];

  const int c = threadIdx.x / LANES, j = threadIdx.x % LANES;
  const int e0 = blockIdx.x * CPB, e = e0 + c;
  const int ce = min(CPB, E - e0);  // channels of the block inside E
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * L;  // (b, t = 0)

  float a[SPL], h[SPL];
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    const int n = j * SPL + s;
    a[s] = (c < ce && n < N) ? A[static_cast<int64_t>(e) * N + n] : 0.f;
    h[s] = 0.f;
  }

  // the next chunk's dt, x (CPB channels) and B, C rows, loaded into
  // registers while this chunk computes
  constexpr int kPerX = (CHUNK * CPB + kThreads - 1) / kThreads;
  constexpr int kPerB = (CHUNK * NP + kThreads - 1) / kThreads;
  float nd[kPerX], nx[kPerX], nb[kPerB], nc[kPerB];
  auto load_chunk = [&](int t0) {
    const int steps = min(CHUNK, L - t0);
#pragma unroll
    for (int k = 0; k < kPerX; ++k) {
      const int i = threadIdx.x + k * kThreads, r = i / CPB, cc = i % CPB;
      nd[k] = nx[k] = 0.f;
      if (i < CHUNK * CPB && r < steps && cc < ce) {
        const int64_t at = (row0 + t0 + r) * E + e0 + cc;
        nd[k] = widen(dt[at]);
        nx[k] = widen(x[at]);
      }
    }
#pragma unroll
    for (int k = 0; k < kPerB; ++k) {
      const int i = threadIdx.x + k * kThreads, r = i / NP, n = i % NP;
      nb[k] = nc[k] = 0.f;
      if (i < CHUNK * NP && r < steps && n < N) {
        const int64_t at = (row0 + t0 + r) * N + n;
        nb[k] = widen(Bm[at]);
        nc[k] = widen(Cm[at]);
      }
    }
  };
  load_chunk(0);

  for (int t0 = 0; t0 < L; t0 += CHUNK) {
    const int steps = min(CHUNK, L - t0);
    if constexpr (CKPT) {  // h before step t0
      if (c < ce) {
        const int chunks = (L + CHUNK - 1) / CHUNK;
        float* dst = h_ckpt + ((static_cast<int64_t>(blockIdx.y) * chunks +
                                t0 / CHUNK) * E + e) * N;
#pragma unroll
        for (int s = 0; s < SPL; ++s) {
          if (j * SPL + s < N) dst[j * SPL + s] = h[s];
        }
      }
    }
    __syncthreads();  // the previous chunk's tiles are no longer read
#pragma unroll
    for (int k = 0; k < kPerX; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < CHUNK * CPB) {
        s_dt[i / CPB][i % CPB] = nd[k];
        s_x[i / CPB][i % CPB] = nx[k];
      }
    }
#pragma unroll
    for (int k = 0; k < kPerB; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < CHUNK * NP) {
        s_b[i / NP][i % NP] = nb[k];
        s_c[i / NP][i % NP] = nc[k];
      }
    }
    __syncthreads();
    if (t0 + CHUNK < L) load_chunk(t0 + CHUNK);
    for (int g0 = 0; g0 < steps; g0 += LANES) {
      float part[LANES];
#pragma unroll
      for (int u = 0; u < LANES; ++u) {
        const int i = g0 + u;
        const float dtv = s_dt[i][c];
        const float dx = dtv * s_x[i][c];
        float sum = 0.f;
        // SPL independent chains: the compiler interleaves them
#pragma unroll
        for (int s = 0; s < SPL; ++s) {
          const int n = j * SPL + s;
          const float decay = expf(dtv * a[s]);
          const float drive = dx * s_b[i][n];
          h[s] = decay * h[s] + drive;
          const float term = h[s] * s_c[i][n];
          sum = s == 0 ? term : sum + term;
        }
        part[u] = sum;
      }
      s_y[g0 + j][c] = transpose_sum<LANES>(part, j);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < steps * CPB; i += kThreads) {
      const int r = i / CPB, cc = i % CPB;
      if (cc < ce) store(y + (row0 + t0 + r) * E + e0 + cc, s_y[r][cc]);
    }
  }
}

template <typename T, int N>
int launch(const void* dt, const void* Bm, const void* Cm, const void* x,
           const void* A, void* y, float* h_ckpt, int Bsz, int L, int E,
           cudaStream_t stream) {
  constexpr int CPB = Split<N>::CPB;
  const dim3 grid((E + CPB - 1) / CPB, Bsz);
  const T* dt_ = static_cast<const T*>(dt);
  const T* b_ = static_cast<const T*>(Bm);
  const T* c_ = static_cast<const T*>(Cm);
  const T* x_ = static_cast<const T*>(x);
  const float* a_ = static_cast<const float*>(A);
  if constexpr (std::is_same<T, float>::value) {
    if (h_ckpt != nullptr) {
      scan_kernel<T, N, true><<<grid, kThreads, 0, stream>>>(
          dt_, b_, c_, x_, a_, static_cast<T*>(y), h_ckpt, L, E);
      return static_cast<int>(cudaGetLastError());
    }
  } else {
    if (h_ckpt != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  }
  scan_kernel<T, N, false><<<grid, kThreads, 0, stream>>>(
      dt_, b_, c_, x_, a_, static_cast<T*>(y), nullptr, L, E);
  return static_cast<int>(cudaGetLastError());
}

// one instantiation per state size 1..kMaxState
template <typename T, int N = kMaxState>
int launch_n(int n, const void* dt, const void* Bm, const void* Cm,
             const void* x, const void* A, void* y, float* h_ckpt, int Bsz,
             int L, int E, cudaStream_t stream) {
  if (n == N) {
    return launch<T, N>(dt, Bm, Cm, x, A, y, h_ckpt, Bsz, L, E, stream);
  }
  if constexpr (N > 1) {
    return launch_n<T, N - 1>(n, dt, Bm, Cm, x, A, y, h_ckpt, Bsz, L, E,
                              stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// --------------------------------------------------------------------------
// The backward.  With g = dL/dy, the exact gradient of the recurrence the
// forward computes, for channel (b, e) and state n, walking t = L-1 .. 0:
//   dh_t    = g_t C_t[n] + carry,      carry = decay_{t+1} dh_{t+1}
//   dprod   = (dh_t h_{t-1}) decay_t    (the gradient of dt_t A[e, n])
//   ddt_t   = sum_n dprod A[e, n] + x_t sum_n dh_t B_t[n]
//   dx_t    = dt_t sum_n dh_t B_t[n]
//   dA[e,n] = sum over b and t of dprod dt_t
//   dB_t[n] = sum over e of dh_t (dt_t x_t),  dC_t[n] = sum over e of g_t h_t
// The plain version (ref.py selective_scan_bwd_ref) runs the same
// recurrence with the same roundings; the sums over n and over e, the
// order of dB's and dC's terms and dA's order over t are where the two
// differ.
//
// Bound: at falcon-mamba-7b's train shape (B = 1, L = 4096, E = 8192,
// N = 16) the function reads dt, x and g and writes ddt and dx (5 x 134
// MB) and reads the checkpoints (67 MB): 0.74 GB, 0.22 ms at 3.35 TB/s;
// its 5.4e8 state updates take one exp each (0.13 ms on the
// special-function units) and about 19 float32 operations (0.15 ms at
// 67 TFLOP/s).  What bounds the kernels below is the instructions they run: the
// chunk kernel's code for one chunk of one channel group (64 state
// updates a lane) is about 4,300 instructions (tools/probe_kernels.py
// --sass, at N = 16): the recompute (its exp is 8 a state update) and
// the reverse step, the xor trees of the sums over n and e, and the
// staging and stores; at 235 registers an SM holds 2 of its blocks.
//
// Design: only the adjoint's carry runs across the whole of L; every
// chunk's states can be recomputed from the forward's checkpoints on
// their own.  The chunk kernel (scan_bwd_chunk) does a chunk of one
// group of CPB channels at a time, an item, in the forward's layout
// (Split<N>: LANES lanes a channel, SPL states a lane, CPB channels to
// 128 threads).  It recomputes the chunk's states from the checkpoint
// into registers, keeping their decays (CHUNK x SPL floats a lane each:
// one exp a state update), and walks them backwards from the carry in;
// the next item's dt, x, g, checkpoint and carry are loaded into
// registers, and the next chunk's B and C rows into shared memory
// (cp.async), while an item computes.  The wrapper chooses how a block
// covers L (bwd_plan in kernel.py, from the grid and the chunk kernel's
// blocks the card holds at once, selective_scan_bwd_occupancy):
//   * walk (split = 0): a block walks all of L for `groups` channel
//     groups, the carry and dA kept between chunks (in shared memory,
//     per group).  No carry pass; the sums are the single walk's.  Taken
//     where those blocks fill the card (falcon-mamba-7b's train shape:
//     512 groups, 256 blocks of 2 on 132 SMs at 2 blocks an SM).
//   * split (split != 0): first scan_bwd_carry, one thread a state
//     (b, e, n): it walks t = L-1 .. CHUNK once, dh = g C + carry, carry
//     = decay dh, rounded as the plain backward rounds, and writes the
//     carry that enters each chunk's reverse walk, carry_in (B, chunks,
//     E, N) (zero for the last).  Only one multiply and one add a step
//     are on that chain; a cp.async ring holds kCarryStages groups of
//     kCarrySteps steps of dt, g and C ahead, and each group's exps
//     interleave with the chain of the group before.  Then the chunk
//     kernel runs one block a chunk and kBwdGroups channel groups, from
//     those carries (hymba-1.5b's train shape: 100 groups, 1,664 blocks
//     where the walk had 100).  Two exps a state update in all.
//   * sums inside the chunk kernel: over n (ddt, dx) the forward's
//     transposing xor tree over a channel's LANES lanes, LANES steps at a
//     time; over e (dB, dC) a transposing xor tree over the channel
//     groups of a warp (lane offsets LANES .. 16) for the 2 SPL values of
//     a lane (dh dt x and g h for each state), added in shared memory
//     over the block's groups in turn, then over its 4 warps in order:
//     one partial a block and step, part (2, B, L, blocks, N); dA over
//     the block's steps (the last first) in registers, one partial a
//     block's run of chunks, dA_part (B, chunks or 1, E, N).
//   * sum_middle sums the dB / dC partials over the blocks and the dA
//     partials over (b, chunk), each in index order.  No float atomics:
//     two launches give the same bits.
// The carries, dh and so ddt, dx and dB's and dC's terms are the same
// functions of the same bits either way; only dA's order of summation
// differs when L is split.
// --------------------------------------------------------------------------

// channel groups of CPB a block of the chunk kernel walks in turn when L
// is split (its dB / dC partial covers all of them), and at most when it
// walks all of L; the carry pass's steps a group and groups of steps in
// flight in its ring.  Measured with tools/probe_kernels.py on an H100
// 80GB HBM3 at 700 W (PERF.md): kBwdGroups 8 against 1, 2, 4, 16;
// kWalkGroups 2 (the falcon-mamba-7b train shape's plan) against 1;
// kCarrySteps 32 (16 at N = 1, a chunk) against 8, 16; kCarryStages 4
// against 2, 3, 8.
constexpr int kBwdGroups = 8;
constexpr int kWalkGroups = 2;
constexpr int kCarrySteps = 32;
constexpr int kCarryStages = 4;

// Sums v[0..V-1] over the G channel groups of a warp (lane offsets
// LANES, 2 LANES, ..., 16; G >= V, both powers of two): while a lane
// holds several values, each xor round keeps half of them and sends the
// other half to its partner; then plain xor rounds.  On return v[0] is
// the warp's total of value idx, and `writer` marks one lane of each
// (idx, lane in group) pair.
template <int COUNT, int OG, int LANES, int V>
__device__ __forceinline__ void group_sum(float (&v)[V], int q, int& idx,
                                          bool& writer) {
  if constexpr (OG >= 1) {
    const bool upper = q & OG;
    if constexpr (COUNT >= 2) {
      constexpr int HALF = COUNT / 2;
#pragma unroll
      for (int u = 0; u < HALF; ++u) {
        const float send = upper ? v[u] : v[u + HALF];
        const float keep = upper ? v[u + HALF] : v[u];
        v[u] = __fadd_rn(keep,
                         __shfl_xor_sync(0xffffffffu, send, OG * LANES));
      }
      if (upper) idx += HALF;
      group_sum<HALF, OG / 2, LANES, V>(v, q, idx, writer);
    } else {
      v[0] = __fadd_rn(v[0],
                       __shfl_xor_sync(0xffffffffu, v[0], OG * LANES));
      if (upper) writer = false;
      group_sum<1, OG / 2, LANES, V>(v, q, idx, writer);
    }
  }
}

// cp.async of one float, global -> shared (lands by cp_async_wait); with
// ok false it reads nothing and writes a zero
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(to),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most PENDING of this thread's newest groups are in flight
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

template <int N>
struct CarrySplit {
  static constexpr int CHUNK = Split<N>::CHUNK;
  static constexpr int CBC = kThreads / N;  // channels a block
  // steps a group (a divisor of CHUNK) and groups in the ring
  static constexpr int U = kCarrySteps < CHUNK ? kCarrySteps : CHUNK;
  static constexpr int FIT = 40960 / (4 * (U + 4) * (2 * CBC + N));
  static constexpr int STAGES =
      FIT < 2 ? 2 : (FIT < kCarryStages ? FIT : kCarryStages);
};

template <int N>
__global__ void __launch_bounds__(kThreads)
    scan_bwd_carry(const float* __restrict__ dt, const float* __restrict__ Cm,
                   const float* __restrict__ A, const float* __restrict__ g,
                   float* __restrict__ carry_in, int L, int E) {
  using P = CarrySplit<N>;
  constexpr int CHUNK = P::CHUNK, U = P::U, CBC = P::CBC, S = P::STAGES;
  static_assert(CHUNK % U == 0 && U % 4 == 0,
                "a chunk holds whole groups of steps, read 4 at a time");
  // time runs along the rows: a thread reads 4 steps in one load; rows
  // of UP floats keep those loads 16-byte aligned and conflict-free
  constexpr int UP = U + 4;
  __shared__ __align__(16) float s_dt[S][CBC][UP];
  __shared__ __align__(16) float s_g[S][CBC][UP];
  __shared__ __align__(16) float s_c[S][N][UP];

  const int c = threadIdx.x / N, n = threadIdx.x % N;
  const int e0 = blockIdx.x * CBC, e = e0 + c;
  const int ce = min(CBC, E - e0);
  const bool mine = c < ce;  // this thread holds state (b, e, n)
  const int cr = mine ? c : 0;  // the column it reads
  const int b = blockIdx.y, chunks = (L + CHUNK - 1) / CHUNK;
  const int64_t row0 = static_cast<int64_t>(b) * L;  // (b, t = 0)
  const int64_t EN = static_cast<int64_t>(E) * N;
  // chunk k's carry of this state at k E N
  float* out = carry_in + static_cast<int64_t>(b) * chunks * EN +
               static_cast<int64_t>(e) * N + n;
  const float a = mine ? A[static_cast<int64_t>(e) * N + n] : 0.f;

  // steps q U .. q U + U - 1 into ring slot q % S: the block's dt and g
  // columns and the C rows, zeros past L and E (decay 1, nothing added)
  auto fetch = [&](int q) {
    const int slot = q % S;
#pragma unroll
    for (int i = threadIdx.x; i < U * CBC; i += kThreads) {
      const int u = i / CBC, v = i % CBC, t = q * U + u;
      const bool ok = t < L && v < ce;
      const int64_t at = ok ? (row0 + t) * E + e0 + v : 0;
      cp_async4(&s_dt[slot][v][u], dt + at, ok);
      cp_async4(&s_g[slot][v][u], g + at, ok);
    }
#pragma unroll
    for (int i = threadIdx.x; i < U * N; i += kThreads) {
      const int u = i / N, m = i % N, t = q * U + u;
      const bool ok = t < L;
      cp_async4(&s_c[slot][m][u], Cm + (ok ? (row0 + t) * N + m : 0), ok);
    }
    cp_async_commit();
  };
  // the decays and g C of group q, from its slot
  auto prep = [&](int q, float(&dec)[U], float(&gc)[U]) {
    const int slot = q % S;
#pragma unroll
    for (int u = 0; u < U; u += 4) {
      const float4 d4 = *reinterpret_cast<const float4*>(&s_dt[slot][cr][u]);
      const float4 g4 = *reinterpret_cast<const float4*>(&s_g[slot][cr][u]);
      const float4 c4 = *reinterpret_cast<const float4*>(&s_c[slot][n][u]);
      dec[u] = expf(d4.x * a);
      dec[u + 1] = expf(d4.y * a);
      dec[u + 2] = expf(d4.z * a);
      dec[u + 3] = expf(d4.w * a);
      gc[u] = g4.x * c4.x;
      gc[u + 1] = g4.y * c4.y;
      gc[u + 2] = g4.z * c4.z;
      gc[u + 3] = g4.w * c4.w;
    }
  };

  float carry = 0.f;
  if (mine) out[static_cast<int64_t>(chunks - 1) * EN] = carry;
  constexpr int kLow = CHUNK / U;  // chunk 0's steps: no carry needed
  const int top = (L - 1) / U;
  if (top < kLow) return;  // one chunk (the same for the whole block)
  // group q is fetched S - 1 groups ahead of its walk; an empty commit
  // past the last keeps the count
  auto fetch_or_not = [&](int q) {
    if (q >= kLow) {
      fetch(q);
    } else {
      cp_async_commit();
    }
  };
#pragma unroll
  for (int p = 0; p < S - 1; ++p) fetch_or_not(top - p);
  // one step of the walk: group q's chain (its decays ready in dec, gc)
  // beside group q - 1's loads and exps, which do not wait on the chain
  // (one branch-free stretch, so that the two interleave; at q = kLow
  // the exps read a slot no group fills, and go unused)
  auto walk = [&](int q, float(&dec)[U], float(&gc)[U], float(&dn)[U],
                  float(&gn)[U]) {
    cp_async_wait<S - 2>();  // group q - 1 has landed
    __syncthreads();         // for every thread; q's slot is read
    prep(q - 1, dn, gn);
#pragma unroll
    for (int u = U - 1; u >= 0; --u) carry = dec[u] * (gc[u] + carry);
    if (mine && (q * U) % CHUNK == 0)  // chunk q U / CHUNK done
      out[static_cast<int64_t>(q * U / CHUNK - 1) * EN] = carry;
    fetch_or_not(q - S);  // into q's slot
  };
  float d0[U], g0[U], d1[U], g1[U];
  cp_async_wait<S - 2>();  // group top has landed
  __syncthreads();
  fetch_or_not(top - (S - 1));
  prep(top, d0, g0);
  for (int q = top; q >= kLow; q -= 2) {  // two a turn: no register copies
    walk(q, d0, g0, d1, g1);
    if (q - 1 >= kLow) walk(q - 1, d1, g1, d0, g0);
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    scan_bwd_chunk(const float* __restrict__ dt, const float* __restrict__ Bm,
                   const float* __restrict__ Cm, const float* __restrict__ x,
                   const float* __restrict__ A,
                   const float* __restrict__ h_ckpt,
                   const float* __restrict__ carry_in,
                   const float* __restrict__ g, float* __restrict__ ddt,
                   float* __restrict__ dx, float* __restrict__ part,
                   float* __restrict__ dA_part, int L, int E, int groups) {
  using P = Split<N>;
  constexpr int LANES = P::LANES, SPL = P::SPL, NP = P::NP, CPB = P::CPB;
  constexpr int CHUNK = P::CHUNK;
  constexpr int G = 32 / LANES;            // channel groups a warp
  constexpr int V = 2 * SPL;               // dB and dC terms a lane
  constexpr int WARPS = kThreads / 32;
  static_assert(V <= G, "a lane's values fit the warp's groups");
  __shared__ float s_dt[CHUNK][CPB];
  __shared__ float s_x[CHUNK][CPB];
  __shared__ float s_g[CHUNK][CPB];
  // the B and C rows of a chunk, by its parity: the next chunk's land
  // while this one's groups compute
  __shared__ float s_bc[2][2][CHUNK][NP];
  __shared__ float s_red[CHUNK][WARPS][V][LANES];
  __shared__ float s_ddt[CHUNK][CPB + 1];
  __shared__ float s_dx[CHUNK][CPB + 1];
  // a walk over several chunks: each group's carry and dA between them
  __shared__ float s_carry[kWalkGroups][SPL][kThreads];
  __shared__ float s_dA[kWalkGroups][SPL][kThreads];

  const int c = threadIdx.x / LANES, j = threadIdx.x % LANES;
  const int w = threadIdx.x / 32, q = (threadIdx.x % 32) / LANES;
  const int b = blockIdx.z, blocks = gridDim.x, slices = gridDim.y;
  const int chunks = (L + CHUNK - 1) / CHUNK, per = chunks / slices;
  const int k_lo = blockIdx.y * per, k_hi = k_lo + per - 1;
  const int e_first = blockIdx.x * groups * CPB;
  const int ngrp = min(groups, (E - e_first + CPB - 1) / CPB);  // inside E
  const int items = per * ngrp;  // (chunk, group): chunks last first

  // an item's dt, x, g (CPB channels; zeros past L and E) and each lane's
  // checkpoint and carry in, loaded into registers while the item before
  // computes
  constexpr int kPer = CHUNK * CPB / kThreads;
  static_assert(kThreads % CPB == 0 && (CHUNK * CPB) % kThreads == 0,
                "a tile is whole rounds of the block's threads");
  float nd[kPer], nx[kPer], ng[kPer], nh[SPL], nk[SPL];
  // this thread's column of a staged tile and its first row; its rows
  // step by kThreads / CPB (CPB divides kThreads)
  constexpr int kRowStep = kThreads / CPB;
  const int col = threadIdx.x % CPB, row = threadIdx.x / CPB;
  auto load_item = [&](int it) {
    const int k = k_hi - it / ngrp, e0 = e_first + (it % ngrp) * CPB;
    const int steps = min(CHUNK, L - k * CHUNK), ce = min(CPB, E - e0);
    const int64_t at0 =
        (static_cast<int64_t>(b) * L + k * CHUNK + row) * E + e0 + col;
    const int64_t step = static_cast<int64_t>(kRowStep) * E;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      nd[u] = nx[u] = ng[u] = 0.f;
      if (row + u * kRowStep < steps && col < ce) {
        nd[u] = dt[at0 + u * step];
        nx[u] = x[at0 + u * step];
        ng[u] = g[at0 + u * step];
      }
    }
    // (b, k, e0 + c, n) of the checkpoints and carries
    const int64_t ck =
        ((static_cast<int64_t>(b) * chunks + k) * E + e0 + c) * N;
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
      const int n = j * SPL + s;
      const bool in = c < ce && n < N;
      nh[s] = in ? h_ckpt[ck + n] : 0.f;
      nk[s] = in && carry_in != nullptr ? carry_in[ck + n] : 0.f;
    }
  };
  // chunk k's B and C rows (zeros past L and N) into s_bc[k & 1]
  auto fetch_bc = [&](int k) {
    const int steps = min(CHUNK, L - k * CHUNK);
    const int64_t row0 = static_cast<int64_t>(b) * L + k * CHUNK;
    for (int i = threadIdx.x; i < CHUNK * NP; i += kThreads) {
      const int r = i / NP, n = i % NP;
      const bool ok = r < steps && n < N;
      const int64_t at = ok ? (row0 + r) * N + n : 0;
      cp_async4(&s_bc[k & 1][0][r][n], Bm + at, ok);
      cp_async4(&s_bc[k & 1][1][r][n], Cm + at, ok);
    }
    cp_async_commit();
  };
  fetch_bc(k_hi);
  load_item(0);

  for (int it = 0; it < items; ++it) {
    const int k = k_hi - it / ngrp, grp = it % ngrp;
    const int t0 = k * CHUNK, steps = min(CHUNK, L - t0);
    const int64_t row0 = static_cast<int64_t>(b) * L + t0;  // (b, t0)
    const int e0 = e_first + grp * CPB, ce = min(CPB, E - e0), e = e0 + c;
    const float(*s_b)[NP] = s_bc[k & 1][0];
    const float(*s_c)[NP] = s_bc[k & 1][1];
    if (grp == 0) cp_async_wait<0>();  // the chunk's B and C rows
    __syncthreads();  // the item before's tiles are no longer read
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      s_dt[row + u * kRowStep][col] = nd[u];
      s_x[row + u * kRowStep][col] = nx[u];
      s_g[row + u * kRowStep][col] = ng[u];
    }
    // the carry into the chunk's walk and the group's dA so far: from
    // the carry pass (or zero) at the first chunk, then from the chunk
    // after
    float a[SPL], h0[SPL], carry[SPL], dA[SPL];
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
      const int n = j * SPL + s;
      a[s] = (c < ce && n < N) ? A[static_cast<int64_t>(e) * N + n] : 0.f;
      h0[s] = nh[s];
      carry[s] = k == k_hi ? nk[s] : s_carry[grp][s][threadIdx.x];
      dA[s] = k == k_hi ? 0.f : s_dA[grp][s][threadIdx.x];
    }
    __syncthreads();
    // the next chunk's B and C rows into the slot the chunk before used
    if (grp == 0 && k > k_lo) fetch_bc(k - 1);
    if (it + 1 < items) load_item(it + 1);

    // the chunk's states and their decays, as the forward computes them
    // (steps past L are staged with dt = 0 and leave the state as it is)
    float hs[CHUNK][SPL], dec[CHUNK][SPL];
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      const float dtv = s_dt[i][c];
      const float dxv = dtv * s_x[i][c];
#pragma unroll
      for (int s = 0; s < SPL; ++s) {
        dec[i][s] = expf(dtv * a[s]);
        const float drive = dxv * s_b[i][j * SPL + s];
        hs[i][s] = dec[i][s] * (i == 0 ? h0[s] : hs[i - 1][s]) + drive;
      }
    }

    // the reverse walk (g = 0 past L, so those steps add nothing)
    float p1[LANES], p2[LANES];
#pragma unroll
    for (int i = CHUNK - 1; i >= 0; --i) {
      const float dtv = s_dt[i][c], xv = s_x[i][c], gv = s_g[i][c];
      const float dxv = dtv * xv;
      float vals[V];
      float sum1 = 0.f, sum2 = 0.f;
#pragma unroll
      for (int s = 0; s < SPL; ++s) {
        const int n = j * SPL + s;
        const float dh = gv * s_c[i][n] + carry[s];
        const float hprev = i == 0 ? h0[s] : hs[i - 1][s];
        const float dprod = (dh * hprev) * dec[i][s];
        dA[s] = dA[s] + dprod * dtv;
        const float t1 = dprod * a[s];
        const float t2 = dh * s_b[i][n];
        sum1 = s == 0 ? t1 : sum1 + t1;
        sum2 = s == 0 ? t2 : sum2 + t2;
        vals[s] = dh * dxv;
        vals[SPL + s] = gv * hs[i][s];
        carry[s] = dec[i][s] * dh;
      }
      p1[i % LANES] = sum1;
      p2[i % LANES] = sum2;
      if (i % LANES == 0) {  // steps i .. i + LANES - 1: lane j takes i + j
        const float s1 = transpose_sum<LANES>(p1, j);
        const float s2 = transpose_sum<LANES>(p2, j);
        const float xj = s_x[i + j][c], dtj = s_dt[i + j][c];
        s_ddt[i + j][c] = s1 + xj * s2;
        s_dx[i + j][c] = dtj * s2;
      }
      int idx = 0;
      bool writer = true;
      group_sum<V, G / 2, LANES, V>(vals, q, idx, writer);
      if (writer) {  // the chunk's groups in turn
        float& acc = s_red[i][w][idx][j];
        acc = grp == 0 ? vals[0] : acc + vals[0];
      }
    }
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
      const int n = j * SPL + s;
      if (k > k_lo) {
        s_carry[grp][s][threadIdx.x] = carry[s];
        s_dA[grp][s][threadIdx.x] = dA[s];
      } else if (c < ce && n < N) {
        dA_part[((static_cast<int64_t>(b) * slices + blockIdx.y) * E + e) *
                    N + n] = dA[s];
      }
    }
    __syncthreads();
    if (col < ce) {
      const int64_t at0 = (row0 + row) * E + e0 + col;
      const int64_t step = static_cast<int64_t>(kRowStep) * E;
      for (int r = row, u = 0; r < steps; r += kRowStep, ++u) {
        ddt[at0 + u * step] = s_ddt[r][col];
        dx[at0 + u * step] = s_dx[r][col];
      }
    }
    if (grp + 1 == ngrp) {  // the chunk's dB / dC partial: its groups'
      // sums in s_red, the warps in order; this thread's (value, lane)
      // is fixed, its steps go by kThreads / (V LANES)
      constexpr int VL = V * LANES;
      static_assert(kThreads % VL == 0, "whole rounds of (value, lane)");
      const int u = (threadIdx.x / LANES) % V, jj = threadIdx.x % LANES;
      const int n = jj * SPL + u % SPL, kind = u / SPL;  // 0: dB, 1: dC
      if (n < N) {
        float* dst = part + ((static_cast<int64_t>(kind) * gridDim.z + b) *
                                 L + t0) * blocks * N +
                     static_cast<int64_t>(blockIdx.x) * N + n;
        const int64_t step = static_cast<int64_t>(blocks) * N;
        for (int r = threadIdx.x / VL; r < steps; r += kThreads / VL) {
          float sum = s_red[r][0][u][jj];
#pragma unroll
          for (int ww = 1; ww < WARPS; ++ww)
            sum = sum + s_red[r][ww][u][jj];
          dst[r * step] = sum;
        }
      }
    }
  }
}

// out[r, c] = sum over k = 0, 1, ..., K-1 (in that order) of in[r, k, c]
__global__ void __launch_bounds__(kThreads)
    sum_middle(const float* __restrict__ in, float* __restrict__ out,
               int64_t R, int K, int C) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= R * C) return;
  const int64_t r = i / C, cc = i % C;
  const float* p = in + r * K * C + cc;
  float acc = p[0];
#pragma unroll 8
  for (int k = 1; k < K; ++k) acc = acc + p[static_cast<int64_t>(k) * C];
  out[i] = acc;
}

int launch_sum(const float* in, float* out, int64_t R, int64_t K, int64_t C,
               cudaStream_t stream) {
  const int64_t n = R * C, grid = (n + kThreads - 1) / kThreads;
  if (grid > 0x7fffffff || K > 0x7fffffff || C > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  sum_middle<<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      in, out, R, static_cast<int>(K), static_cast<int>(C));
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int chunks_of(int L) {
  return (L + Split<N>::CHUNK - 1) / Split<N>::CHUNK;
}

template <int N>
int launch_bwd_carry(const float* dt, const float* Cm, const float* A,
                     const float* g, float* carry, int Bsz, int L, int E,
                     cudaStream_t stream) {
  constexpr int CBC = CarrySplit<N>::CBC;
  const dim3 grid((E + CBC - 1) / CBC, Bsz);
  scan_bwd_carry<N><<<grid, kThreads, 0, stream>>>(dt, Cm, A, g, carry, L,
                                                    E);
  return static_cast<int>(cudaGetLastError());
}

// split != 0: one block a chunk (and `groups` channel groups), from the
// carry pass's carries; else one block a run of `groups` channel groups
// over all of L, the carry kept between chunks (carry unread)
template <int N>
int launch_bwd_chunks(const float* dt, const float* Bm, const float* Cm,
                      const float* x, const float* A, const float* h_ckpt,
                      const float* carry, const float* g, float* ddt,
                      float* dx, float* part, float* dA_part, int Bsz, int L,
                      int E, int split, int groups, cudaStream_t stream) {
  const int chunks = chunks_of<N>(L);
  if (chunks > 65535 || groups < 1 ||
      groups > (split ? kBwdGroups : kWalkGroups) ||
      (split && carry == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int span = Split<N>::CPB * groups;
  const dim3 grid((E + span - 1) / span, split ? chunks : 1, Bsz);
  scan_bwd_chunk<N><<<grid, kThreads, 0, stream>>>(
      dt, Bm, Cm, x, A, h_ckpt, split ? carry : nullptr, g, ddt, dx, part,
      dA_part, L, E, groups);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_bwd(const float* dt, const float* Bm, const float* Cm,
               const float* x, const float* A, const float* h_ckpt,
               const float* g, float* ddt, float* dx, float* carry,
               float* part, float* dA_part, float* dBC, float* dA, int Bsz,
               int L, int E, int split, int groups, cudaStream_t stream) {
  int err = 0;
  if (split) {
    err = launch_bwd_carry<N>(dt, Cm, A, g, carry, Bsz, L, E, stream);
    if (err) return err;
  }
  err = launch_bwd_chunks<N>(dt, Bm, Cm, x, A, h_ckpt, carry, g, ddt, dx,
                             part, dA_part, Bsz, L, E, split, groups, stream);
  if (err) return err;
  const int span = Split<N>::CPB * groups;
  err = launch_sum(part, dBC, 2 * static_cast<int64_t>(Bsz) * L,
                   (E + span - 1) / span, N, stream);
  if (err) return err;
  return launch_sum(dA_part, dA, 1,
                    static_cast<int64_t>(Bsz) * (split ? chunks_of<N>(L) : 1),
                    static_cast<int64_t>(E) * N, stream);
}

// f(std::integral_constant<int, n>()): one instantiation per state size
// 1..kMaxState
template <int N = kMaxState, typename F>
int with_state_size(int n, const F& f) {
  if (n == N) return f(std::integral_constant<int, N>());
  if constexpr (N > 1) return with_state_size<N - 1>(n, f);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool bwd_shape_ok(int Bsz, int L, int E, int N) {
  return Bsz > 0 && Bsz <= 65535 && L > 0 && E > 0 && N > 0 &&
         N <= kMaxState;
}

}  // namespace

// dt, x, y: (B, L, E) contiguous; Bm, Cm: (B, L, N) contiguous; A: (E, N)
// contiguous float32.  bf16 != 0: dt, Bm, Cm, x and y are bfloat16, else
// float32.  h_ckpt: null, or (float32 only) the (B, ceil(L / CHUNK), E, N)
// float32 checkpoints of the states.  Returns a cudaError_t (0 when the
// launch was accepted).
extern "C" int selective_scan(const void* dt, const void* Bm, const void* Cm,
                              const void* x, const void* A, void* y,
                              void* h_ckpt, int bf16, int Bsz, int L, int E,
                              int N, cudaStream_t stream) {
  if (Bsz <= 0 || Bsz > 65535 || L <= 0 || E <= 0 || N <= 0 ||
      N > kMaxState)
    return static_cast<int>(cudaErrorInvalidValue);
  float* ckpt = static_cast<float*>(h_ckpt);
  return bf16 ? launch_n<__nv_bfloat16>(N, dt, Bm, Cm, x, A, y, ckpt, Bsz,
                                        L, E, stream)
              : launch_n<float>(N, dt, Bm, Cm, x, A, y, ckpt, Bsz, L, E,
                                stream);
}

using F = const float*;

// The backward, float32 only.  dt, x, g (dL/dy): (B, L, E); Bm, Cm:
// (B, L, N); A: (E, N); h_ckpt: the forward's (B, chunks, E, N)
// checkpoints, chunks = ceil(L / CHUNK); all contiguous.  Writes ddt, dx
// (B, L, E), dBC (2, B, L, N) = (dB, dC) and dA (E, N).  split != 0: the
// carry pass into carry (B, chunks, E, N), then one chunk kernel block a
// (groups x CPB channels, chunk, b), groups <= kBwdGroups; split = 0: no
// carry pass (carry may be null), one block a (groups x CPB channels, b)
// over all of L, groups <= kWalkGroups.  Scratch: part (2, B, L, blocks,
// N), blocks = ceil(E / (groups CPB)), and dA_part (B, split ? chunks :
// 1, E, N).  Launches on `stream` (the carry pass, the chunk kernel, the
// two sums); returns the first cudaError_t that is not 0, else 0.
extern "C" int selective_scan_bwd(const void* dt, const void* Bm,
                                  const void* Cm, const void* x,
                                  const void* A, const void* h_ckpt,
                                  const void* g, void* ddt, void* dx,
                                  void* carry, void* part, void* dA_part,
                                  void* dBC, void* dA, int Bsz, int L, int E,
                                  int N, int split, int groups,
                                  cudaStream_t stream) {
  if (!bwd_shape_ok(Bsz, L, E, N))
    return static_cast<int>(cudaErrorInvalidValue);
  return with_state_size(N, [&](auto n) {
    return launch_bwd<decltype(n)::value>(
        static_cast<F>(dt), static_cast<F>(Bm), static_cast<F>(Cm),
        static_cast<F>(x), static_cast<F>(A), static_cast<F>(h_ckpt),
        static_cast<F>(g), static_cast<float*>(ddt), static_cast<float*>(dx),
        static_cast<float*>(carry), static_cast<float*>(part),
        static_cast<float*>(dA_part), static_cast<float*>(dBC),
        static_cast<float*>(dA), Bsz, L, E, split, groups, stream);
  });
}

// Blocks of the chunk kernel at state size N that an SM of the current
// device holds at once (its registers and shared memory as compiled),
// into *blocks: the wrapper's plan weighs the walk's blocks against them.
// Launches nothing; returns a cudaError_t.
extern "C" int selective_scan_bwd_occupancy(int N, int* blocks) {
  if (N <= 0 || N > kMaxState || blocks == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_state_size(N, [&](auto n) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, scan_bwd_chunk<decltype(n)::value>, kThreads, 0));
  });
}

// The backward's first two launches on their own, to time each: the
// carry pass (writes carry) and the chunk kernel (reads carry when split,
// writes ddt, dx and the partials); operands as in selective_scan_bwd.
extern "C" int selective_scan_bwd_carry(const void* dt, const void* Cm,
                                        const void* A, const void* g,
                                        void* carry, int Bsz, int L, int E,
                                        int N, cudaStream_t stream) {
  if (!bwd_shape_ok(Bsz, L, E, N))
    return static_cast<int>(cudaErrorInvalidValue);
  return with_state_size(N, [&](auto n) {
    return launch_bwd_carry<decltype(n)::value>(
        static_cast<F>(dt), static_cast<F>(Cm), static_cast<F>(A),
        static_cast<F>(g), static_cast<float*>(carry), Bsz, L, E, stream);
  });
}

extern "C" int selective_scan_bwd_chunks(
    const void* dt, const void* Bm, const void* Cm, const void* x,
    const void* A, const void* h_ckpt, const void* carry, const void* g,
    void* ddt, void* dx, void* part, void* dA_part, int Bsz, int L, int E,
    int N, int split, int groups, cudaStream_t stream) {
  if (!bwd_shape_ok(Bsz, L, E, N))
    return static_cast<int>(cudaErrorInvalidValue);
  return with_state_size(N, [&](auto n) {
    return launch_bwd_chunks<decltype(n)::value>(
        static_cast<F>(dt), static_cast<F>(Bm), static_cast<F>(Cm),
        static_cast<F>(x), static_cast<F>(A), static_cast<F>(h_ckpt),
        static_cast<F>(carry), static_cast<F>(g), static_cast<float*>(ddt),
        static_cast<float*>(dx), static_cast<float*>(part),
        static_cast<float*>(dA_part), Bsz, L, E, split, groups, stream);
  });
}
