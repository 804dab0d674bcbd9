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
// Design (simple first; a chunked parallel scan over L, or several
// channels a warp, is later work):
//   * One thread per channel (b, e): its N <= 16 states and A[e, :] live
//     in registers, and it walks t = 0 .. L-1 in order.  The TPU kernel
//     carried the state in VMEM across a sequential grid axis of chunks;
//     Hopper runs blocks in no order, so the time loop is inside the
//     thread.  N is a template parameter (instantiated for 1..16), so the
//     N updates of a step unroll into independent chains that the
//     compiler interleaves.
//   * A block holds 64 consecutive channels of one batch row (grid
//     (ceil(E / 64), B)).  Per chunk of 64 time steps it stages its
//     (64 x 64) tiles of dt and x in shared memory (each warp reads 32
//     neighbouring elements of a row: coalesced) and the chunk's B_t and
//     C_t rows, which all its channels share.
//   * Ragged edges: any L >= 1 and E >= 1.  Threads past E load and store
//     nothing but take part in the staging of B and C and in the
//     barriers; the last chunk is shorter.  No padding exists.
//   * Occupancy: B * E / 32 warps in all (512 at the falcon shape, about
//     one per scheduler of the 132 SMs; 100 at hymba's E = 1600), so the
//     time is that of one thread's serial walk over L, not the bound's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;   // channels of a block, one a thread
constexpr int kChunk = 64;     // time steps staged per pass
constexpr int kMaxState = 16;  // the largest N the kernel takes (a
                               // template parameter: h[N] in registers)

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const T* __restrict__ dt, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const T* __restrict__ x,
                const float* __restrict__ A, T* __restrict__ y, int L,
                int E) {
  __shared__ float s_dt[kChunk][kThreads];
  __shared__ float s_x[kChunk][kThreads];
  __shared__ float s_b[kChunk][N];
  __shared__ float s_c[kChunk][N];

  const int tid = threadIdx.x;
  const int e = blockIdx.x * kThreads + tid;
  const bool active = e < E;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * L;  // (b, t = 0)

  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = active ? A[static_cast<int64_t>(e) * N + n] : 0.f;
    h[n] = 0.f;
  }

  for (int t0 = 0; t0 < L; t0 += kChunk) {
    const int steps = min(kChunk, L - t0);
    __syncthreads();  // the previous chunk's tiles are no longer read
    if (active) {
#pragma unroll 16
      for (int i = 0; i < steps; ++i) {
        const int64_t at = (row0 + t0 + i) * E + e;
        s_dt[i][tid] = widen(dt[at]);
        s_x[i][tid] = widen(x[at]);
      }
    }
    const int64_t bc0 = (row0 + t0) * N;
    for (int i = tid; i < steps * N; i += kThreads) {
      s_b[i / N][i % N] = widen(Bm[bc0 + i]);
      s_c[i / N][i % N] = widen(Cm[bc0 + i]);
    }
    __syncthreads();
    if (!active) continue;
    for (int i = 0; i < steps; ++i) {
      const float dtv = s_dt[i][tid];
      const float dx = dtv * s_x[i][tid];
      float acc = 0.f;
      // N independent chains: the compiler interleaves them (a runtime N
      // would split them into N guarded blocks, one after the other)
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float decay = expf(dtv * a[n]);
        const float drive = dx * s_b[i][n];
        h[n] = decay * h[n] + drive;
        acc = acc + h[n] * s_c[i][n];
      }
      store(y + (row0 + t0 + i) * E + e, acc);
    }
  }
}

template <typename T, int N>
int launch(const void* dt, const void* Bm, const void* Cm, const void* x,
           const void* A, void* y, int Bsz, int L, int E,
           cudaStream_t stream) {
  const dim3 grid((E + kThreads - 1) / kThreads, Bsz);
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
