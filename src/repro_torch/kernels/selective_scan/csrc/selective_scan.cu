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
//   dA[e,n] = sum over b, then over t (from L-1 down) of dprod dt_t
//   dB_t[n] = sum over e of dh_t (dt_t x_t),  dC_t[n] = sum over e of g_t h_t
// The plain version (ref.py selective_scan_bwd_ref) runs the same
// recurrence with the same roundings; the sums over n, over e and the
// order of dB's and dC's terms are where the two differ.
//
// Bound: at falcon-mamba-7b's train shape (B = 1, L = 4096, E = 8192,
// N = 16) the function reads dt, x and g and writes ddt and dx (5 x 134
// MB) and reads the checkpoints (67 MB): 0.74 GB, 0.22 ms at 3.35 TB/s;
// its 5.4e8 state updates take one exp each (0.13 ms on the
// special-function units) and about 19 float32 operations (0.15 ms at
// 67 TFLOP/s).  This kernel also writes and reads back the dB / dC
// partials of 512 blocks (2 x 2 x 134 MB, 1.3 GB in all) and takes two
// exps a state update (the chunk's states recomputed, then the decay in
// the reverse walk).
//
// Design: the forward's layout (Split<N>: LANES lanes a channel, SPL
// states a lane, CPB channels a block of 128 threads, chunks of CHUNK
// steps), with the chunks walked in reverse.  For each chunk the block
// stages dt, x, g of its channels and the B, C rows in shared memory,
// loads each lane's states from the checkpoint of the chunk's start and
// recomputes the chunk's CHUNK states into registers (CHUNK x SPL floats
// a lane, 64 at N = 16: both step loops are unrolled), then walks it
// backwards with the carry in registers across chunks.
//   * sum over n (ddt, dx): the forward's transposing xor tree over the
//     channel's LANES lanes, LANES steps at a time;
//   * sum over e: a transposing xor tree over the channel groups of a
//     warp (lane offsets LANES .. 16) for the 2 SPL values of a lane (dh
//     dt x and g h for each state), then the block's 4 warps in order
//     through shared memory, written as one partial a block:
//     part (2, B, L, blocks, N).  A second kernel sums the partials over
//     the blocks in index order.  No float atomics: two launches give
//     the same bits;
//   * dA: each lane sums its states' terms over t in registers (from
//     L-1 down), writes dA_part (B, E, N), and the second kernel sums it
//     over b in index order.
// --------------------------------------------------------------------------

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

template <int N>
__global__ void __launch_bounds__(kThreads)
    scan_bwd_kernel(const float* __restrict__ dt, const float* __restrict__ Bm,
                    const float* __restrict__ Cm,
                    const float* __restrict__ x, const float* __restrict__ A,
                    const float* __restrict__ h_ckpt,
                    const float* __restrict__ g, float* __restrict__ ddt,
                    float* __restrict__ dx, float* __restrict__ part,
                    float* __restrict__ dA_part, int L, int E) {
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
  __shared__ float s_b[CHUNK][NP];
  __shared__ float s_c[CHUNK][NP];
  __shared__ float s_red[CHUNK][WARPS][V][LANES];
  __shared__ float s_ddt[CHUNK][CPB + 1];
  __shared__ float s_dx[CHUNK][CPB + 1];

  const int c = threadIdx.x / LANES, j = threadIdx.x % LANES;
  const int w = threadIdx.x / 32, q = (threadIdx.x % 32) / LANES;
  const int e0 = blockIdx.x * CPB, e = e0 + c;
  const int ce = min(CPB, E - e0);
  const int b = blockIdx.y, blocks = gridDim.x;
  const int64_t row0 = static_cast<int64_t>(b) * L;
  const int chunks = (L + CHUNK - 1) / CHUNK;

  float a[SPL], carry[SPL], dA[SPL];
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    const int n = j * SPL + s;
    a[s] = (c < ce && n < N) ? A[static_cast<int64_t>(e) * N + n] : 0.f;
    carry[s] = 0.f;
    dA[s] = 0.f;
  }

  for (int k = chunks - 1; k >= 0; --k) {
    const int t0 = k * CHUNK, steps = min(CHUNK, L - t0);
    __syncthreads();  // the previous chunk's tiles are no longer read
    for (int i = threadIdx.x; i < CHUNK * CPB; i += kThreads) {
      const int r = i / CPB, cc = i % CPB;
      float vd = 0.f, vx = 0.f, vg = 0.f;
      if (r < steps && cc < ce) {
        const int64_t at = (row0 + t0 + r) * E + e0 + cc;
        vd = dt[at];
        vx = x[at];
        vg = g[at];
      }
      s_dt[r][cc] = vd;
      s_x[r][cc] = vx;
      s_g[r][cc] = vg;
    }
    for (int i = threadIdx.x; i < CHUNK * NP; i += kThreads) {
      const int r = i / NP, n = i % NP;
      float vb = 0.f, vc = 0.f;
      if (r < steps && n < N) {
        const int64_t at = (row0 + t0 + r) * N + n;
        vb = Bm[at];
        vc = Cm[at];
      }
      s_b[r][n] = vb;
      s_c[r][n] = vc;
    }
    float h0[SPL];
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
      const int n = j * SPL + s;
      h0[s] = (c < ce && n < N)
                  ? h_ckpt[((static_cast<int64_t>(b) * chunks + k) * E + e) *
                               N + n]
                  : 0.f;
    }
    __syncthreads();

    // the chunk's states, as the forward computes them (steps past L
    // are staged with dt = 0 and leave the state as it is)
    float hs[CHUNK][SPL];
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      const float dtv = s_dt[i][c];
      const float dxv = dtv * s_x[i][c];
#pragma unroll
      for (int s = 0; s < SPL; ++s) {
        const float decay = expf(dtv * a[s]);
        const float drive = dxv * s_b[i][j * SPL + s];
        hs[i][s] = decay * (i == 0 ? h0[s] : hs[i - 1][s]) + drive;
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
        const float decay = expf(dtv * a[s]);
        const float dprod = (dh * hprev) * decay;
        dA[s] = dA[s] + dprod * dtv;
        const float t1 = dprod * a[s];
        const float t2 = dh * s_b[i][n];
        sum1 = s == 0 ? t1 : sum1 + t1;
        sum2 = s == 0 ? t2 : sum2 + t2;
        vals[s] = dh * dxv;
        vals[SPL + s] = gv * hs[i][s];
        carry[s] = decay * dh;
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
      if (writer) s_red[i][w][idx][j] = vals[0];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < steps * CPB; i += kThreads) {
      const int r = i / CPB, cc = i % CPB;
      if (cc < ce) {
        const int64_t at = (row0 + t0 + r) * E + e0 + cc;
        ddt[at] = s_ddt[r][cc];
        dx[at] = s_dx[r][cc];
      }
    }
    for (int i = threadIdx.x; i < steps * V * LANES; i += kThreads) {
      const int r = i / (V * LANES), u = (i / LANES) % V, jj = i % LANES;
      const int n = jj * SPL + u % SPL;
      if (n < N) {
        float sum = s_red[r][0][u][jj];
#pragma unroll
        for (int ww = 1; ww < WARPS; ++ww) sum = sum + s_red[r][ww][u][jj];
        const int kind = u / SPL;  // 0: dB, 1: dC
        part[(((static_cast<int64_t>(kind) * gridDim.y + b) * L + t0 + r) *
                  blocks + blockIdx.x) * N + n] = sum;
      }
    }
  }
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    const int n = j * SPL + s;
    if (c < ce && n < N)
      dA_part[(static_cast<int64_t>(b) * E + e) * N + n] = dA[s];
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

int launch_sum(const float* in, float* out, int64_t R, int K, int C,
               cudaStream_t stream) {
  const int64_t n = R * C, grid = (n + kThreads - 1) / kThreads;
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  sum_middle<<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(in, out,
                                                                  R, K, C);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_bwd(const float* dt, const float* Bm, const float* Cm,
               const float* x, const float* A, const float* h_ckpt,
               const float* g, float* ddt, float* dx, float* part,
               float* dA_part, float* dBC, float* dA, int Bsz, int L, int E,
               cudaStream_t stream) {
  constexpr int CPB = Split<N>::CPB;
  const int blocks = (E + CPB - 1) / CPB;
  const dim3 grid(blocks, Bsz);
  scan_bwd_kernel<N><<<grid, kThreads, 0, stream>>>(
      dt, Bm, Cm, x, A, h_ckpt, g, ddt, dx, part, dA_part, L, E);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  err = launch_sum(part, dBC, 2 * static_cast<int64_t>(Bsz) * L, blocks, N,
                   stream);
  if (err) return err;
  return launch_sum(dA_part, dA, 1, Bsz, E * N, stream);
}

template <int N = kMaxState>
int launch_bwd_n(int n, const float* dt, const float* Bm, const float* Cm,
                 const float* x, const float* A, const float* h_ckpt,
                 const float* g, float* ddt, float* dx, float* part,
                 float* dA_part, float* dBC, float* dA, int Bsz, int L,
                 int E, cudaStream_t stream) {
  if (n == N) {
    return launch_bwd<N>(dt, Bm, Cm, x, A, h_ckpt, g, ddt, dx, part, dA_part,
                         dBC, dA, Bsz, L, E, stream);
  }
  if constexpr (N > 1) {
    return launch_bwd_n<N - 1>(n, dt, Bm, Cm, x, A, h_ckpt, g, ddt, dx, part,
                               dA_part, dBC, dA, Bsz, L, E, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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


// The backward, float32 only.  dt, x, g (dL/dy): (B, L, E); Bm, Cm:
// (B, L, N); A: (E, N); h_ckpt: the forward's (B, ceil(L / CHUNK), E, N)
// checkpoints; all contiguous.  Writes ddt, dx (B, L, E), dBC (2, B, L,
// N) = (dB, dC) and dA (E, N), using part (2, B, L, ceil(E / CPB), N) and
// dA_part (B, E, N) as scratch.  Three launches on `stream`; returns the
// first cudaError_t that is not 0, else 0.
extern "C" int selective_scan_bwd(const void* dt, const void* Bm,
                                  const void* Cm, const void* x,
                                  const void* A, const void* h_ckpt,
                                  const void* g, void* ddt, void* dx,
                                  void* part, void* dA_part, void* dBC,
                                  void* dA, int Bsz, int L, int E, int N,
                                  cudaStream_t stream) {
  if (Bsz <= 0 || Bsz > 65535 || L <= 0 || E <= 0 || N <= 0 ||
      N > kMaxState)
    return static_cast<int>(cudaErrorInvalidValue);
  using F = const float*;
  return launch_bwd_n(N, static_cast<F>(dt), static_cast<F>(Bm),
                      static_cast<F>(Cm), static_cast<F>(x),
                      static_cast<F>(A), static_cast<F>(h_ckpt),
                      static_cast<F>(g), static_cast<float*>(ddt),
                      static_cast<float*>(dx), static_cast<float*>(part),
                      static_cast<float*>(dA_part),
                      static_cast<float*>(dBC), static_cast<float*>(dA), Bsz,
                      L, E, stream);
}
