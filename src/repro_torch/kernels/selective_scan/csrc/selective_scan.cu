// Mamba selective scan (S6), forward only, for Hopper (sm_90a).
// Plain C interface, loaded with ctypes by repro_torch/kernels/
// selective_scan/kernel.py.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   selective_scan <- repro/kernels/selective_scan/kernel.py
//                     selective_scan (_scan_kernel)
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const T* __restrict__ dt, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const T* __restrict__ x,
                const float* __restrict__ A, T* __restrict__ y, int L,
                int E) {
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
           const void* A, void* y, int Bsz, int L, int E,
           cudaStream_t stream) {
  constexpr int CPB = Split<N>::CPB;
  const dim3 grid((E + CPB - 1) / CPB, Bsz);
  scan_kernel<T, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const T*>(x),
      static_cast<const float*>(A), static_cast<T*>(y), L, E);
  return static_cast<int>(cudaGetLastError());
}

// one instantiation per state size 1..kMaxState
template <typename T, int N = kMaxState>
int launch_n(int n, const void* dt, const void* Bm, const void* Cm,
             const void* x, const void* A, void* y, int Bsz, int L, int E,
             cudaStream_t stream) {
  if (n == N) return launch<T, N>(dt, Bm, Cm, x, A, y, Bsz, L, E, stream);
  if constexpr (N > 1) {
    return launch_n<T, N - 1>(n, dt, Bm, Cm, x, A, y, Bsz, L, E, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dt, x, y: (B, L, E) contiguous; Bm, Cm: (B, L, N) contiguous; A: (E, N)
// contiguous float32.  bf16 != 0: dt, Bm, Cm, x and y are bfloat16, else
// float32.  Returns a cudaError_t (0 when the launch was accepted).
extern "C" int selective_scan(const void* dt, const void* Bm, const void* Cm,
                              const void* x, const void* A, void* y, int bf16,
                              int Bsz, int L, int E, int N,
                              cudaStream_t stream) {
  if (Bsz <= 0 || Bsz > 65535 || L <= 0 || E <= 0 || N <= 0 ||
      N > kMaxState)
    return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? launch_n<__nv_bfloat16>(N, dt, Bm, Cm, x, A, y, Bsz, L, E,
                                        stream)
              : launch_n<float>(N, dt, Bm, Cm, x, A, y, Bsz, L, E, stream);
}
