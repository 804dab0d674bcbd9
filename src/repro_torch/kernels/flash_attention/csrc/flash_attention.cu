// Flash attention (streaming softmax), forward only, for Hopper (sm_90a).
// Plain C interface, loaded with ctypes by repro_torch/kernels/
// flash_attention/kernel.py.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   flash_attention <- repro/kernels/flash_attention/kernel.py
//                      flash_attention (_flash_kernel)
// It computes what _flash_kernel computes, in the same order and with the
// same constants: per KV tile, s = (q . k) * scale with scale =
// float32(1/sqrt(D)); masked scores are -1e30 (not -inf);
// m_cur = max(m_prev, rowmax(s)), alpha = exp(m_prev - m_cur),
// p = exp(s - m_cur), l = l * alpha + rowsum(p), acc = acc * alpha + p v;
// the output is acc / max(l, 1e-30) by IEEE division, rounded once to the
// output type.  Running max, denominator and accumulator are float32.
//
// Bound: causal attention at the prefill shapes (B = 2, S = T = 4096,
// H = 32, D = 64) does 4 D flops per visible (query, key) pair, about 512
// flops per byte of q, k, v and output in float32, far above the card's
// ridge: the kernel is bound by operations, not by memory.  This first
// design runs them on the CUDA cores in float32 (67 TFLOP/s peak); a
// wgmma / TMA design on the tensor cores is later work.
//
// Design:
//   * One tile shape, BQ = BK = 64: staged in float32 it takes 219,136
//     bytes of shared memory at D = 256, inside Hopper's 227 KB a block
//     (a static_assert holds it), so it serves every head dim.
//   * Grid (query tiles, batch * heads).  The TPU's sequential kv grid
//     axis, whose VMEM scratch carried m, l and acc from step to step,
//     becomes a loop over KV tiles inside the block; m, l and acc live in
//     registers.  Query tiles are issued last-first, so the causal tiles
//     with the most work start first.
//   * 256 threads as a 16 x 16 grid.  For S = Q K^T a thread owns BQ/16
//     query rows (tr, tr + 16, ...) and BK/16 keys (tc, tc + 16, ...) and
//     reads float4 chunks of both from shared memory: 2 (BQ + BK) / 16
//     16-byte loads per 4 BQ BK / 256 fused multiply-adds.  The scores go
//     through shared memory once (P) so that for P V the same thread owns
//     the same rows and D/16 output columns (4 tc + 64 m).  Rows padded by
//     4 floats (Q, K) and 16 floats (P) keep the loads free of bank
//     conflicts; V rows need none.
//   * Row max and row sum are reduced across the 16 threads of a row by
//     xor shuffles; every thread of the row ends with the same bits
//     (float addition is commutative).
//   * GQA: query head h reads KV head h / (H / Kv) in place, from the
//     (B, S, H, D) / (B, T, Kv, D) layout with the caller's strides (the
//     last axis contiguous): no repeat and no transposed copies.
//   * Ragged edges: any S, T >= 1.  Query rows past S are computed on zero
//     inputs and not stored; keys past T are zero in shared memory and
//     score -inf, so they add exactly nothing (masked keys inside T score
//     -1e30, as in the reference, which matters for a row that sees no
//     key at all).
//   * Tile skipping: when every query row of the tile sees at least one
//     key, KV tiles wholly above the causal diagonal and wholly before the
//     window are skipped.  That changes no value: above the diagonal the
//     reference adds p = 0 with alpha = 1; before the window it adds
//     exp(0) terms under m = -1e30, which the first visible tile wipes out
//     with alpha = exp(-1e30 - m) = 0.  A tile holding a row that sees no
//     key (a window with S > T) walks every KV tile, as the reference does.
//   * f32 and bf16 inputs: loads widen with __bfloat162float, the math is
//     float32, the store rounds with __float2bfloat16_rn.  expf (not
//     __expf); the dot loops are explicit fmaf (the library is built with
//     --fmad=false for the other kernels' bit-exact contracts; this
//     kernel's contract is a tolerance).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;  // the reference's NEG_INF
constexpr int kThreads = 256;      // a 16 x 16 thread grid over each tile
constexpr int BQ = 64, BK = 64;    // query rows and keys of a tile
constexpr int kSmemPerBlock = 227 * 1024;  // Hopper, dynamic shared memory

template <int D>
struct Tile {
  static_assert(D % 64 == 0, "head dim");
  static constexpr int QLD = D + 4;   // Q and K rows in shared memory
  static constexpr int VLD = D;       // V rows
  static constexpr int PLD = BK + 16; // P rows
  static constexpr int RM = BQ / 16;  // query rows per thread
  static constexpr int CN = BK / 16;  // keys per thread
  static constexpr int DC = D / 64;   // float4 output columns per thread
  static constexpr int kSmem =
      (BQ * QLD + BK * QLD + BK * VLD + BQ * PLD) * (int)sizeof(float);
};
static_assert(Tile<256>::kSmem <= kSmemPerBlock,
              "the tile must fit a block's shared memory at D = 256");

struct Strides {  // in elements; the last axis is contiguous
  int64_t qb, qs, qh, kb, kt, kh, vb, vt, vh;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const __nv_bfloat162 a = p2[0], b = p2[1];
  return make_float4(__bfloat162float(a.x), __bfloat162float(a.y),
                     __bfloat162float(b.x), __bfloat162float(b.y));
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  p[0] = __float2bfloat16_rn(x.x);
  p[1] = __float2bfloat16_rn(x.y);
  p[2] = __float2bfloat16_rn(x.z);
  p[3] = __float2bfloat16_rn(x.w);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// max / sum over the 16 threads of a row (lanes 0-15 or 16-31 of a warp)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// rows [0, n) of a (n, D) tile from global memory (row stride `stride`)
// into shared memory (row stride ld); rows at or past `valid` are zero
template <typename T, int D, int ROWS>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      int64_t stride, int valid) {
  constexpr int C4 = D / 4;              // float4 chunks per row
  constexpr int STEP = kThreads / C4;    // rows per pass
  const int c = threadIdx.x % C4;
#pragma unroll
  for (int r = threadIdx.x / C4; r < ROWS; r += STEP) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) x = load4(src + r * stride + 4 * c);
    *reinterpret_cast<float4*>(dst + r * ld + 4 * c) = x;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int S, int Tk, int H,
          int group, Strides st, int causal, int window, float scale) {
  using L = Tile<D>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * L::QLD;
  float* Vs = Ks + BK * L::QLD;
  float* Ps = Vs + BK * L::VLD;

  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / group;
  const T* kb = k + b * st.kb + kvh * st.kh;
  const T* vb = v + b * st.vb + kvh * st.vh;

  stage<T, D, BQ>(Qs, L::QLD, q + b * st.qb + h * st.qh + q0 * st.qs, st.qs,
                  S - q0);

  // KV tiles to visit (see "Tile skipping" above)
  const int q_last = min(q0 + BQ, S) - 1;
  int kt_begin = 0, kt_end = (Tk + BK - 1) / BK;
  if (window <= 0 || q_last - (Tk - 1) < window) {
    if (causal) kt_end = min(kt_end, q_last / BK + 1);
    if (window > 0) kt_begin = max(0, q0 - window + 1) / BK;
  }

  float m[L::RM], l[L::RM];
  float4 acc[L::RM][L::DC];
#pragma unroll
  for (int i = 0; i < L::RM; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < L::DC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    stage<T, D, BK>(Ks, L::QLD, kb + k0 * st.kt, st.kt, Tk - k0);
    stage<T, D, BK>(Vs, L::VLD, vb + k0 * st.vt, st.vt, Tk - k0);
    __syncthreads();

    // s = q . k over D, one fmaf chain per score
    float s[L::RM][L::CN];
#pragma unroll
    for (int i = 0; i < L::RM; ++i)
#pragma unroll
      for (int j = 0; j < L::CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[L::RM], kv[L::CN];
#pragma unroll
      for (int i = 0; i < L::RM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (tr + 16 * i) * L::QLD + d);
#pragma unroll
      for (int j = 0; j < L::CN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tc + 16 * j) * L::QLD + d);
#pragma unroll
      for (int i = 0; i < L::RM; ++i)
#pragma unroll
        for (int j = 0; j < L::CN; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // scale, mask, online softmax; P to shared memory
#pragma unroll
    for (int i = 0; i < L::RM; ++i) {
      const int row = q0 + tr + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < L::CN; ++j) {
        const int key = k0 + tc + 16 * j;
        float x = __fmul_rn(s[i][j], scale);
        if (key >= Tk)
          x = -INFINITY;  // padding past T: contributes nothing
        else if ((causal && key > row) || (window > 0 && row - key >= window))
          x = kMasked;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_cur = fmaxf(m[i], row_max(mx));
      const float alpha = expf(__fsub_rn(m[i], m_cur));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < L::CN; ++j) {
        const float p = expf(__fsub_rn(s[i][j], m_cur));
        Ps[(tr + 16 * i) * L::PLD + tc + 16 * j] = p;
        sum = __fadd_rn(sum, p);
      }
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha), row_sum(sum));
      m[i] = m_cur;
#pragma unroll
      for (int c = 0; c < L::DC; ++c) {
        acc[i][c].x = __fmul_rn(acc[i][c].x, alpha);
        acc[i][c].y = __fmul_rn(acc[i][c].y, alpha);
        acc[i][c].z = __fmul_rn(acc[i][c].z, alpha);
        acc[i][c].w = __fmul_rn(acc[i][c].w, alpha);
      }
    }
    __syncthreads();  // P complete

    // acc += P V over the tile's keys
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pv[L::RM];
#pragma unroll
      for (int i = 0; i < L::RM; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (tr + 16 * i) * L::PLD + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = Vs + (j + jj) * L::VLD + 4 * tc;
#pragma unroll
        for (int c = 0; c < L::DC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + 64 * c);
#pragma unroll
          for (int i = 0; i < L::RM; ++i) {
            const float p = comp(pv[i], jj);
            acc[i][c].x = fmaf(p, vv.x, acc[i][c].x);
            acc[i][c].y = fmaf(p, vv.y, acc[i][c].y);
            acc[i][c].z = fmaf(p, vv.z, acc[i][c].z);
            acc[i][c].w = fmaf(p, vv.w, acc[i][c].w);
          }
        }
      }
    }
  }

  // out = acc / max(l, 1e-30), IEEE division, one rounding to T
#pragma unroll
  for (int i = 0; i < L::RM; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + (((int64_t)b * S + row) * H + h) * D + 4 * tc;
#pragma unroll
    for (int c = 0; c < L::DC; ++c)
      store4(orow + 64 * c,
             make_float4(__fdiv_rn(acc[i][c].x, den), __fdiv_rn(acc[i][c].y, den),
                         __fdiv_rn(acc[i][c].z, den), __fdiv_rn(acc[i][c].w, den)));
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, S, T, H, Kv;
  Strides st;
  int causal, window;
  float scale;
};

template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  using L = Tile<D>;
  auto kernel = flash_fwd<T, D>;
  // above 48 KB only as dynamic shared memory, after this opt-in
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + BQ - 1) / BQ, a.B * a.H);
  kernel<<<grid, kThreads, L::kSmem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.S, a.T, a.H,
      a.H / a.Kv, a.st, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dim(const Args& a, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    case 256: return launch<T, 256>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, S, H, D), k / v (B, T, Kv, D) with the given strides (elements;
// last axis contiguous), out (B, S, H, D) contiguous, all float32
// (bf16 == 0) or all bfloat16 (bf16 == 1).  window <= 0: no window.
// Returns the launch's cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int bf16, int B, int S, int T,
                               int H, int Kv, int D, int64_t q_sb,
                               int64_t q_ss, int64_t q_sh, int64_t k_sb,
                               int64_t k_st, int64_t k_sh, int64_t v_sb,
                               int64_t v_st, int64_t v_sh, int causal,
                               int window, float scale,
                               cudaStream_t stream) {
  if (B <= 0 || S <= 0 || T <= 0 || H <= 0 || Kv <= 0 || H % Kv ||
      (int64_t)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, B, S, T, H, Kv,
               Strides{q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh},
               causal, window, scale};
  return bf16 ? launch_dim<__nv_bfloat16>(a, D, stream)
              : launch_dim<float>(a, D, stream);
}
