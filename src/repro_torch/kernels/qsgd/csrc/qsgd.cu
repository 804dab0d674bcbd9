// QSGD kernels for Hopper (sm_90a): pack, fused, unpack, the server's
// fused decode->reduce and the explicit-noise quantize-dequantize.  Plain
// C interface, loaded with ctypes by repro_torch/kernels/qsgd/kernel.py
// and ops.py.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   qsgd_pack    <- repro/kernels/qsgd/kernel.py  qsgd_pack_pallas   (_qsgd_pack_kernel)
//   qsgd_fused   <- repro/kernels/qsgd/kernel.py  qsgd_fused_pallas  (_qsgd_fused_kernel)
//   qsgd_unpack  <- repro/kernels/qsgd/kernel.py  qsgd_unpack_pallas (_qsgd_unpack_kernel)
//   qsgd_reduce  <- repro/kernels/qsgd/ops.py     _qsgd_reduce_pallas (_qsgd_reduce_kernel)
//   qsgd_dequantized <- repro/kernels/qsgd/kernel.py qsgd_dequantized (_qsgd_kernel)
//
// Bound: all five are streaming passes that do a few operations per byte
// (the counter hash is ~12 integer operations per element), far below
// the card's operations-per-byte ridge, so each is bound by device
// memory traffic: every input read once, every output written once
// (qsgd_dequantized: x and the noise read, y written, 12 bytes an
// element in float32).
//
// Design:
//   * pack / fused: one block per (bucket row, client).  Pass 1 sums x*x
//     over the row with a fixed thread->element assignment, a warp
//     shuffle tree and a shared-memory tree, so the bucket norm is
//     deterministic (it differs from a sequential sum by ulps, which the
//     tests bound).  Pass 2 re-reads the row (from L1/L2: 8 KB at the
//     default bucket) and quantizes.  Rows with bucket % 4 == 0 and
//     16-byte-aligned input use float4 loads; pack and fused pick the
//     same path by the same rule, so their norms agree bit for bit.
//   * The dither noise is the counter hash of the element's flat index
//     in its client's (n_buckets, bucket) view, modulo 2^32, exactly as
//     repro/kernels/rng.py computes it; per-client seed words come from
//     the host-side key schedule.  No noise array ever exists.
//   * unpack / reduce: each thread owns 16 consecutive elements (one
//     16-byte load of int8 codes per client); a warp's 32 groups leave
//     through a shared-memory stage so that its float4 stores are
//     contiguous.  The reduce replaces the TPU kernel's VMEM accumulator
//     carried across a sequential client grid axis with a loop over
//     clients 0..n-1 inside the thread, the accumulator in registers:
//     one store, no atomics, O(d) state.
//   * qsgd_dequantized (the leafwise codec's kernel, noise drawn by the
//     caller from threefry): one block per bucket row, pass 1 a
//     deterministic tree sum of x*x as above, pass 2 reads x (again, from
//     L1/L2) and the noise once and writes y once.  float32 or bfloat16
//     x (widened on load, y rounded back to nearest even), float32
//     noise, any levels >= 1 (the leafwise codec allows int16 codes).
//     sign(x) * q is formed as torch.sign(x) * q: -0.0 where x < 0 rounds
//     to level 0, +0.0 for x = +-0.  The row's norm can be written out
//     for the layered check (codes exact given the same norms).
//   * Rounding: every operation is an explicit round-to-nearest
//     intrinsic and the library is built with --fmad=false, so no
//     multiply-add is contracted; results equal the plain PyTorch
//     versions bit for bit given the same codes and norms.  The level
//     scale norm / s is norm * float32(1 / s), as XLA compiles the
//     reference's division by the constant s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr int kMaxThreads = 256;
constexpr int kGroup = 16;  // elements per thread in unpack / reduce

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// uniform in [0, 1): top 24 bits of the counter hash times 2^-24 (exact)
__device__ __forceinline__ float counter_uniform(uint32_t idx, uint32_t s0,
                                                 uint32_t s1) {
  const uint32_t bits = fmix32((idx * kGolden + s0) ^ s1);
  return __fmul_rn(static_cast<float>(bits >> 8), 5.9604644775390625e-08f);
}

// sign(x) * q with q = floor(scaled) + (u < scaled - floor(scaled)),
// scaled = |x| / safe * s
__device__ __forceinline__ float quantize(float x, float safe, float s,
                                          float u) {
  const float scaled = __fmul_rn(__fdiv_rn(fabsf(x), safe), s);
  const float lo = floorf(scaled);
  const float q = __fadd_rn(lo, u < __fsub_rn(scaled, lo) ? 1.0f : 0.0f);
  return copysignf(q, x);
}

// deterministic block-wide sum; blockDim.x is a multiple of 32, <= 1024
__device__ float block_sum(float v, float* smem) {
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? smem[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) smem[32] = v;
  }
  __syncthreads();
  return smem[32];
}

// One block per (row, client).  PACK writes int8 codes and the norm;
// otherwise writes the dequantized float32 row (zero-norm rows give 0).
// Seeds: per client from `seeds` (n, 2) when given, else (s0, s1).
template <int V, bool PACK>
__global__ void __launch_bounds__(kMaxThreads)
qsgd_row_kernel(const float* __restrict__ x, int8_t* __restrict__ codes,
                float* __restrict__ norms, float* __restrict__ out,
                const uint32_t* __restrict__ seeds, uint32_t s0, uint32_t s1,
                int64_t nb, int64_t b, float s, float inv_s) {
  __shared__ float smem[33];
  const int64_t row = blockIdx.x;
  const int64_t client = blockIdx.y;
  const int64_t base = (client * nb + row) * b;
  const float* xr = x + base;

  float acc = 0.0f;
  if (V == 4) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int64_t j = threadIdx.x; j < b / 4; j += blockDim.x) {
      const float4 v = x4[j];
      acc = __fadd_rn(acc, __fmul_rn(v.x, v.x));
      acc = __fadd_rn(acc, __fmul_rn(v.y, v.y));
      acc = __fadd_rn(acc, __fmul_rn(v.z, v.z));
      acc = __fadd_rn(acc, __fmul_rn(v.w, v.w));
    }
  } else {
    for (int64_t c = threadIdx.x; c < b; c += blockDim.x) {
      const float v = xr[c];
      acc = __fadd_rn(acc, __fmul_rn(v, v));
    }
  }
  const float norm = __fsqrt_rn(block_sum(acc, smem));
  const float safe = norm == 0.0f ? 1.0f : norm;
  const float scale = __fmul_rn(norm, inv_s);
  if (seeds != nullptr) {
    s0 = seeds[2 * client];
    s1 = seeds[2 * client + 1];
  }
  // flat index of (row, c) in this client's view, modulo 2^32
  const uint32_t row0 = static_cast<uint32_t>(row) * static_cast<uint32_t>(b);

  if (V == 4) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int64_t j = threadIdx.x; j < b / 4; j += blockDim.x) {
      const float4 v = x4[j];
      const uint32_t i0 = row0 + static_cast<uint32_t>(4 * j);
      float q[4];
      q[0] = quantize(v.x, safe, s, counter_uniform(i0, s0, s1));
      q[1] = quantize(v.y, safe, s, counter_uniform(i0 + 1u, s0, s1));
      q[2] = quantize(v.z, safe, s, counter_uniform(i0 + 2u, s0, s1));
      q[3] = quantize(v.w, safe, s, counter_uniform(i0 + 3u, s0, s1));
      if (PACK) {
        char4 c4;
        c4.x = static_cast<signed char>(static_cast<int>(q[0]));
        c4.y = static_cast<signed char>(static_cast<int>(q[1]));
        c4.z = static_cast<signed char>(static_cast<int>(q[2]));
        c4.w = static_cast<signed char>(static_cast<int>(q[3]));
        reinterpret_cast<char4*>(codes + base)[j] = c4;
      } else {
        float4 o;
        o.x = norm == 0.0f ? 0.0f : __fmul_rn(q[0], scale);
        o.y = norm == 0.0f ? 0.0f : __fmul_rn(q[1], scale);
        o.z = norm == 0.0f ? 0.0f : __fmul_rn(q[2], scale);
        o.w = norm == 0.0f ? 0.0f : __fmul_rn(q[3], scale);
        reinterpret_cast<float4*>(out + base)[j] = o;
      }
    }
  } else {
    for (int64_t c = threadIdx.x; c < b; c += blockDim.x) {
      const float q = quantize(xr[c], safe, s,
                               counter_uniform(row0 + static_cast<uint32_t>(c),
                                               s0, s1));
      if (PACK)
        codes[base + c] = static_cast<int8_t>(static_cast<int>(q));
      else
        out[base + c] = norm == 0.0f ? 0.0f : __fmul_rn(q, scale);
    }
  }
  if (PACK && threadIdx.x == 0) norms[client * nb + row] = norm;
}

// Each warp owns 32 consecutive groups of 16 elements (one 16-byte load
// of int8 codes per lane) and writes their 512 float32 results through a
// shared-memory stage, so that each float4 store instruction of the warp
// covers 512 contiguous bytes instead of 32 chunks 64 bytes apart.
__device__ __forceinline__ void store_groups(float4* stage, float4* out4,
                                             const float v[kGroup],
                                             int64_t w0, int64_t groups) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kGroup / 4; ++k)
    stage[4 * lane + k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2],
                                      v[4 * k + 3]);
  __syncwarp();
#pragma unroll
  for (int k = 0; k < kGroup / 4; ++k) {
    const int f = 32 * k + lane;             // float4 of the warp's span
    if (w0 + f / 4 < groups) out4[w0 * 4 + f] = stage[f];
  }
  __syncwarp();
}

// codes * (norm / s) for bucket % 16 == 0; warps stride over 32-group spans
__global__ void __launch_bounds__(kMaxThreads)
qsgd_unpack_group_kernel(const int8_t* __restrict__ codes,
                         const float* __restrict__ norms,
                         float* __restrict__ out, int64_t groups, int64_t b,
                         float inv_s) {
  __shared__ float4 stage[kMaxThreads / 32][32 * kGroup / 4];
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t w0 = warp * 32; w0 < groups; w0 += warps * 32) {
    const int64_t g = w0 + lane;
    float v[kGroup];
    if (g < groups) {
      const float scale = __fmul_rn(norms[g * kGroup / b], inv_s);
      alignas(16) int8_t c[kGroup];
      *reinterpret_cast<int4*>(c) = reinterpret_cast<const int4*>(codes)[g];
#pragma unroll
      for (int k = 0; k < kGroup; ++k)
        v[k] = __fmul_rn(static_cast<float>(c[k]), scale);
    }
    store_groups(stage[threadIdx.x >> 5], reinterpret_cast<float4*>(out), v,
                 w0, groups);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
qsgd_unpack_elem_kernel(const int8_t* __restrict__ codes,
                        const float* __restrict__ norms,
                        float* __restrict__ out, int64_t total, int64_t b,
                        float inv_s) {
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * blockDim.x)
    out[e] = __fmul_rn(static_cast<float>(codes[e]),
                       __fmul_rn(norms[e / b], inv_s));
}

// sum_i w_i * codes_i * (norms_i / s), clients in order 0..n-1; one
// accumulator per element, in registers, across the client loop
__device__ __forceinline__ void reduce_group(
    const int8_t* __restrict__ codes, const float* __restrict__ norms,
    const float* __restrict__ weights, int64_t n, int64_t nb, int64_t total,
    int64_t g, int64_t b, float inv_s, float acc[kGroup]) {
  const int64_t row = g * kGroup / b;
#pragma unroll
  for (int k = 0; k < kGroup; ++k) acc[k] = 0.0f;
  for (int64_t i = 0; i < n; ++i) {
    const float scale = __fmul_rn(norms[i * nb + row], inv_s);
    alignas(16) int8_t c[kGroup];
    *reinterpret_cast<int4*>(c) =
        reinterpret_cast<const int4*>(codes + i * total)[g];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      float y = __fmul_rn(static_cast<float>(c[k]), scale);
      if (weights != nullptr) y = __fmul_rn(y, weights[i]);
      acc[k] = __fadd_rn(acc[k], y);
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
qsgd_reduce_group_kernel(const int8_t* __restrict__ codes,
                         const float* __restrict__ norms,
                         const float* __restrict__ weights,
                         float* __restrict__ out, int64_t n, int64_t nb,
                         int64_t b, float inv_s) {
  __shared__ float4 stage[kMaxThreads / 32][32 * kGroup / 4];
  const int lane = threadIdx.x & 31;
  const int64_t total = nb * b;
  const int64_t groups = total / kGroup;
  const int64_t warp =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t w0 = warp * 32; w0 < groups; w0 += warps * 32) {
    const int64_t g = w0 + lane;
    float acc[kGroup];
    if (g < groups)
      reduce_group(codes, norms, weights, n, nb, total, g, b, inv_s, acc);
    store_groups(stage[threadIdx.x >> 5], reinterpret_cast<float4*>(out),
                 acc, w0, groups);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
qsgd_reduce_elem_kernel(const int8_t* __restrict__ codes,
                        const float* __restrict__ norms,
                        const float* __restrict__ weights,
                        float* __restrict__ out, int64_t n, int64_t nb,
                        int64_t b, float inv_s) {
  const int64_t total = nb * b;
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t row = e / b;
    float acc = 0.0f;
    for (int64_t i = 0; i < n; ++i) {
      float y = __fmul_rn(static_cast<float>(codes[i * total + e]),
                          __fmul_rn(norms[i * nb + row], inv_s));
      if (weights != nullptr) y = __fmul_rn(y, weights[i]);
      acc = __fadd_rn(acc, y);
    }
    out[e] = acc;
  }
}

// widen on load / round back to nearest even on store
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// torch.sign(x) * q, scaled = |x| / safe * s, q the stochastic rounding
// of scaled by the given uniform u
__device__ __forceinline__ float quantize_signed(float x, float safe,
                                                 float s, float u) {
  const float scaled = __fmul_rn(__fdiv_rn(fabsf(x), safe), s);
  const float lo = floorf(scaled);
  const float q = __fadd_rn(lo, u < __fsub_rn(scaled, lo) ? 1.0f : 0.0f);
  const float sgn = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  return __fmul_rn(sgn, q);
}

// One block per bucket row of b elements: y = sign(x) q (norm / s), zero
// for a zero-norm row.  V = 4: float32 rows read and written as float4.
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
qsgd_dequantized_kernel(const T* __restrict__ x, const float* __restrict__ u,
                        T* __restrict__ out, float* __restrict__ norms,
                        int64_t b, float s, float inv_s) {
  __shared__ float smem[33];
  const int64_t row = blockIdx.x;
  const int64_t base = row * b;
  float acc = 0.0f;
  if constexpr (V == 4) {
    const float4* x4 = reinterpret_cast<const float4*>(x + base);
    for (int64_t j = threadIdx.x; j < b / 4; j += blockDim.x) {
      const float4 v = x4[j];
      acc = __fadd_rn(acc, __fmul_rn(v.x, v.x));
      acc = __fadd_rn(acc, __fmul_rn(v.y, v.y));
      acc = __fadd_rn(acc, __fmul_rn(v.z, v.z));
      acc = __fadd_rn(acc, __fmul_rn(v.w, v.w));
    }
  } else {
    for (int64_t c = threadIdx.x; c < b; c += blockDim.x) {
      const float v = widen(x[base + c]);
      acc = __fadd_rn(acc, __fmul_rn(v, v));
    }
  }
  const float norm = __fsqrt_rn(block_sum(acc, smem));
  const float safe = norm == 0.0f ? 1.0f : norm;
  const float scale = __fmul_rn(norm, inv_s);
  if constexpr (V == 4) {
    const float4* x4 = reinterpret_cast<const float4*>(x + base);
    const float4* u4 = reinterpret_cast<const float4*>(u + base);
    float4* y4 = reinterpret_cast<float4*>(out + base);
    for (int64_t j = threadIdx.x; j < b / 4; j += blockDim.x) {
      const float4 v = x4[j];
      const float4 r = u4[j];
      float4 o;
      o.x = norm == 0.0f ? 0.0f
                         : __fmul_rn(quantize_signed(v.x, safe, s, r.x), scale);
      o.y = norm == 0.0f ? 0.0f
                         : __fmul_rn(quantize_signed(v.y, safe, s, r.y), scale);
      o.z = norm == 0.0f ? 0.0f
                         : __fmul_rn(quantize_signed(v.z, safe, s, r.z), scale);
      o.w = norm == 0.0f ? 0.0f
                         : __fmul_rn(quantize_signed(v.w, safe, s, r.w), scale);
      y4[j] = o;
    }
  } else {
    for (int64_t c = threadIdx.x; c < b; c += blockDim.x) {
      const float q = quantize_signed(widen(x[base + c]), safe, s, u[base + c]);
      store(out + base + c, norm == 0.0f ? 0.0f : __fmul_rn(q, scale));
    }
  }
  if (norms != nullptr && threadIdx.x == 0) norms[row] = norm;
}

// float32(1 / levels): the reciprocal XLA multiplies by for norm / s
float inv_levels(int levels) {
  return static_cast<float>(1.0 / static_cast<double>(levels));
}

bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) % a) == 0;
}

int row_threads(int64_t units) {
  int64_t t = ((units + 31) / 32) * 32;
  if (t < 32) t = 32;
  if (t > kMaxThreads) t = kMaxThreads;
  return static_cast<int>(t);
}

unsigned int stream_grid(int64_t work) {
  int64_t blocks = (work + kMaxThreads - 1) / kMaxThreads;
  const int64_t cap = 132 * 64;  // grid-stride beyond 64 blocks per SM
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned int>(blocks);
}

int launch_rows(bool pack, const float* x, int8_t* codes, float* norms,
                float* out, const uint32_t* seeds, uint32_t s0, uint32_t s1,
                int64_t n, int64_t nb, int64_t b, int levels,
                cudaStream_t stream) {
  if (n > 65535 || nb > 2147483647LL) return cudaErrorInvalidValue;
  const bool vec = b % 4 == 0 && aligned(x, 16) &&
                   (pack ? aligned(codes, 4) : aligned(out, 16));
  const dim3 grid(static_cast<unsigned int>(nb), static_cast<unsigned int>(n));
  const int threads = row_threads(vec ? b / 4 : b);
  const float s = static_cast<float>(levels);
  const float inv_s = inv_levels(levels);
  if (pack) {
    if (vec)
      qsgd_row_kernel<4, true><<<grid, threads, 0, stream>>>(
          x, codes, norms, out, seeds, s0, s1, nb, b, s, inv_s);
    else
      qsgd_row_kernel<1, true><<<grid, threads, 0, stream>>>(
          x, codes, norms, out, seeds, s0, s1, nb, b, s, inv_s);
  } else {
    if (vec)
      qsgd_row_kernel<4, false><<<grid, threads, 0, stream>>>(
          x, codes, norms, out, seeds, s0, s1, nb, b, s, inv_s);
    else
      qsgd_row_kernel<1, false><<<grid, threads, 0, stream>>>(
          x, codes, norms, out, seeds, s0, s1, nb, b, s, inv_s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (n, nb, b) f32 -> codes (n, nb, b) i8, norms (n, nb) f32;
// seeds (n, 2) u32 on the device.  Returns the cudaError_t of the launch.
int qsgd_pack(const float* x, int8_t* codes, float* norms,
              const uint32_t* seeds, int64_t n, int64_t nb, int64_t b,
              int levels, void* stream) {
  return launch_rows(true, x, codes, norms, nullptr, seeds, 0u, 0u, n, nb, b,
                     levels, static_cast<cudaStream_t>(stream));
}

// x (nb, b) f32 -> out (nb, b) f32, one seed pair
int qsgd_fused(const float* x, float* out, uint32_t s0, uint32_t s1,
               int64_t nb, int64_t b, int levels, void* stream) {
  return launch_rows(false, x, nullptr, nullptr, out, nullptr, s0, s1, 1, nb,
                     b, levels, static_cast<cudaStream_t>(stream));
}

// codes (nb, b) i8, norms (nb) f32 -> out (nb, b) f32
int qsgd_unpack(const int8_t* codes, const float* norms, float* out,
                int64_t nb, int64_t b, int levels, void* stream) {
  const int64_t total = nb * b;
  const float inv_s = inv_levels(levels);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b % kGroup == 0 && aligned(codes, 16) && aligned(out, 16)) {
    const int64_t groups = total / kGroup;
    qsgd_unpack_group_kernel<<<stream_grid(groups), kMaxThreads, 0, st>>>(
        codes, norms, out, groups, b, inv_s);
  } else {
    qsgd_unpack_elem_kernel<<<stream_grid(total), kMaxThreads, 0, st>>>(
        codes, norms, out, total, b, inv_s);
  }
  return static_cast<int>(cudaGetLastError());
}

// codes (n, nb, b) i8, norms (n, nb) f32, weights (n) f32 or null
// -> out (nb, b) f32
int qsgd_reduce(const int8_t* codes, const float* norms, const float* weights,
                float* out, int64_t n, int64_t nb, int64_t b, int levels,
                void* stream) {
  const float inv_s = inv_levels(levels);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b % kGroup == 0 && aligned(codes, 16) && aligned(out, 16)) {
    qsgd_reduce_group_kernel<<<stream_grid(nb * b / kGroup), kMaxThreads, 0,
                               st>>>(codes, norms, weights, out, n, nb, b,
                                     inv_s);
  } else {
    qsgd_reduce_elem_kernel<<<stream_grid(nb * b), kMaxThreads, 0, st>>>(
        codes, norms, weights, out, n, nb, b, inv_s);
  }
  return static_cast<int>(cudaGetLastError());
}

// x (nb, b) float32 (bf16 == 0) or bfloat16, u (nb, b) float32 ->
// out (nb, b) of x's type; norms (nb) float32 written when not null
int qsgd_dequantized(const void* x, const float* u, void* out, float* norms,
                     int64_t nb, int64_t b, int levels, int bf16,
                     void* stream) {
  if (nb > 2147483647LL || levels < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float s = static_cast<float>(levels);
  const float inv_s = inv_levels(levels);
  const unsigned int grid = static_cast<unsigned int>(nb);
  if (bf16) {
    qsgd_dequantized_kernel<__nv_bfloat16, 1><<<grid, row_threads(b), 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), u,
        static_cast<__nv_bfloat16*>(out), norms, b, s, inv_s);
  } else if (b % 4 == 0 && aligned(x, 16) && aligned(u, 16) &&
             aligned(out, 16)) {
    qsgd_dequantized_kernel<float, 4><<<grid, row_threads(b / 4), 0, st>>>(
        static_cast<const float*>(x), u, static_cast<float*>(out), norms, b, s,
        inv_s);
  } else {
    qsgd_dequantized_kernel<float, 1><<<grid, row_threads(b), 0, st>>>(
        static_cast<const float*>(x), u, static_cast<float*>(out), norms, b, s,
        inv_s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
