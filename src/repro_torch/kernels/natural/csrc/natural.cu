// Natural-compression kernels for Hopper (sm_90a): the batched wire
// encode, the fused round-trip, the server's fused decode->reduce and the
// explicit-noise rounding.  Plain C interface, loaded with ctypes by
// repro_torch/kernels/natural/kernel.py and ops.py.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   natural_pack   <- repro/kernels/natural/kernel.py  natural_pack (on the
//                     TPU natural_fused_pallas plus an XLA bit-split; its
//                     specification is ref.py natural_pack_ref)
//   natural_fused  <- repro/kernels/natural/kernel.py  natural_fused_pallas
//                     (_natural_fused_kernel, _round_to_pow2)
//   natural_reduce <- repro/kernels/natural/ops.py     _natural_reduce_pallas
//                     (_natural_reduce_kernel, _merge_tile)
//   natural_compress_2d <- repro/kernels/natural/kernel.py natural_compress_2d
//                     (_natural_kernel, _round_to_pow2 with the given noise)
//
// Bound: all four are streaming passes of a few integer operations per
// element (the counter hash is ~12), far below the card's
// operations-per-byte ridge, so each is bound by device memory traffic:
// pack reads 4 bytes and writes 9 bits per element, fused reads 4 and
// writes 4, the reduce reads 9 bits per element and client and writes 4,
// compress_2d reads x and the noise (4 + 4) and writes 4.
//
// Design:
//   * Rounding is integer work on the float32 bit pattern: zero the
//     mantissa and bump the exponent iff (hash >> 8) < 2 * mantissa, the
//     reference's u < mantissa / 2^23 with both sides exact.  The bump is
//     suppressed where the exponent field is 255 (Inf, NaN); a zero never
//     bumps; subnormals round like any finite value.  No float compare is
//     involved, so the result does not depend on a flush-to-zero mode (the
//     library is built without -ftz and without fast math).
//   * The dither is the counter hash of the element's flat index in its
//     client's buffer, modulo 2^32, as repro/kernels/rng.py computes it;
//     per-client seed words come from the host-side key schedule.
//   * pack / fused: each lane owns one float4 (4 consecutive elements) per
//     iteration, so a warp covers 128 consecutive elements with one
//     16-byte load per lane and writes its 128 exponent codes as one
//     4-byte store per lane.  A lane's 4 signs are a nibble; even lanes
//     take their odd neighbour's nibble by a shuffle and store the byte
//     (bit j of byte k is element 8k + j).
//   * compress_2d (the leafwise codec's kernel, noise drawn by the caller
//     from threefry): elementwise over any contiguous buffer, float32
//     (a float4 per lane where the buffer allows it) or bfloat16 (widened
//     on load; the result, a power of two, Inf, NaN or zero, is exact in
//     bfloat16).  The bump is u < mantissa * 2^-23, the reference's
//     compare, with both sides exact in float32; the passthrough rule is
//     the one above.
//   * reduce: the TPU kernel's VMEM accumulator carried across a
//     sequential client grid axis becomes a loop over clients 0..n-1
//     inside each thread, the accumulators in registers: no atomics, O(d)
//     state.  Each thread owns 16 consecutive elements (one 16-byte load
//     of exponent codes and one 2-byte load of signs per client), and a
//     warp's 32 groups leave through a shared-memory stage so that its
//     float4 stores are contiguous, as qsgd.cu's reduce does; a buffer
//     that is not a multiple of 16 elements takes a float4-per-thread
//     kernel.  y = bitcast((sign << 31) | (exp << 23)) is a power of two,
//     so y * w is exact; the sum is an explicit round-to-nearest add in
//     client order, starting from client 0's term.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr int kThreads = 256;
constexpr int kGroup = 16;               // elements per thread in the reduce
constexpr int64_t kMaxBlocks = 132 * 8;  // one full-occupancy wave

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ bool special(uint32_t bits) {
  return (bits & 0x7F800000u) == 0x7F800000u;
}

// the rounded bit pattern of element `idx` (flat index mod 2^32)
__device__ __forceinline__ uint32_t round_pow2(uint32_t bits, uint32_t idx,
                                               uint32_t s0, uint32_t s1) {
  const uint32_t r = fmix32((idx * kGolden + s0) ^ s1);
  const uint32_t up =
      (!special(bits) && (r >> 8) < ((bits & 0x7FFFFFu) << 1)) ? 1u : 0u;
  return (bits & 0xFF800000u) + (up << 23);
}

// fused output: Inf and NaN keep their bits
__device__ __forceinline__ float fused_one(float v, uint32_t idx, uint32_t s0,
                                           uint32_t s1) {
  const uint32_t bits = __float_as_uint(v);
  return __uint_as_float(special(bits) ? bits : round_pow2(bits, idx, s0, s1));
}

__device__ __forceinline__ float merge(uint32_t exp, uint32_t sign) {
  return __uint_as_float((sign << 31) | (exp << 23));
}

// x (n, quads) float4 -> exps (n, quads) 4 codes each, signs (n, quads / 2)
// bytes; grid (blocks, n), seeds (n, 2).  quads is even.
__global__ void __launch_bounds__(kThreads)
natural_pack_kernel(const float4* __restrict__ x, uint32_t* __restrict__ exps,
                    uint8_t* __restrict__ signs,
                    const uint32_t* __restrict__ seeds, int64_t quads) {
  const int64_t client = blockIdx.y;
  const uint32_t s0 = seeds[2 * client];
  const uint32_t s1 = seeds[2 * client + 1];
  x += client * quads;
  exps += client * quads;
  signs += client * (quads / 2);
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  // warp-uniform trip count: every lane reaches the shuffle
  for (int64_t q0 = warp * 32; q0 < quads; q0 += warps * 32) {
    const int64_t q = q0 + lane;
    uint32_t nibble = 0u;
    if (q < quads) {
      const float4 v = x[q];
      const uint32_t i0 = static_cast<uint32_t>(q) * 4u;
      const uint32_t o0 = round_pow2(__float_as_uint(v.x), i0, s0, s1);
      const uint32_t o1 = round_pow2(__float_as_uint(v.y), i0 + 1u, s0, s1);
      const uint32_t o2 = round_pow2(__float_as_uint(v.z), i0 + 2u, s0, s1);
      const uint32_t o3 = round_pow2(__float_as_uint(v.w), i0 + 3u, s0, s1);
      exps[q] = ((o0 >> 23) & 0xFFu) | (((o1 >> 23) & 0xFFu) << 8) |
                (((o2 >> 23) & 0xFFu) << 16) | (((o3 >> 23) & 0xFFu) << 24);
      nibble = (o0 >> 31) | ((o1 >> 31) << 1) | ((o2 >> 31) << 2) |
               ((o3 >> 31) << 3);
    }
    const uint32_t odd = __shfl_down_sync(0xffffffffu, nibble, 1);
    if ((lane & 1) == 0 && q < quads)
      signs[q >> 1] = static_cast<uint8_t>(nibble | (odd << 4));
  }
}

__global__ void __launch_bounds__(kThreads)
natural_fused_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                     uint32_t s0, uint32_t s1, int64_t quads) {
  for (int64_t q = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       q < quads; q += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float4 v = x[q];
    const uint32_t i0 = static_cast<uint32_t>(q) * 4u;
    out[q] = make_float4(fused_one(v.x, i0, s0, s1),
                         fused_one(v.y, i0 + 1u, s0, s1),
                         fused_one(v.z, i0 + 2u, s0, s1),
                         fused_one(v.w, i0 + 3u, s0, s1));
  }
}

// the rounding of one value with the given uniform u: the exponent is
// bumped iff u < mantissa * 2^-23 (both exact in float32); Inf and NaN
// keep their bits
__device__ __forceinline__ float noise_one(float v, float u) {
  const uint32_t bits = __float_as_uint(v);
  if (special(bits)) return v;
  const float prob =
      __fmul_rn(static_cast<float>(bits & 0x7FFFFFu), 1.1920928955078125e-07f);
  return __uint_as_float((bits & 0xFF800000u) + (u < prob ? 1u << 23 : 0u));
}

__global__ void __launch_bounds__(kThreads)
natural_noise_quad_kernel(const float4* __restrict__ x,
                          const float4* __restrict__ u,
                          float4* __restrict__ out, int64_t quads) {
  for (int64_t q = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       q < quads; q += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float4 v = x[q];
    const float4 r = u[q];
    out[q] = make_float4(noise_one(v.x, r.x), noise_one(v.y, r.y),
                         noise_one(v.z, r.z), noise_one(v.w, r.w));
  }
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
natural_noise_kernel(const T* __restrict__ x, const float* __restrict__ u,
                     T* __restrict__ out, int64_t total) {
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * blockDim.x)
    store(out + e, noise_one(widen(x[e]), u[e]));
}

// client i's term w_i * bitcast((sign << 31) | (exp << 23)) of element k
// of a group, from the group's exponent codes and sign bits
__device__ __forceinline__ float term(uint32_t exps_word, uint32_t sign_bits,
                                      int k, const float* __restrict__ weights,
                                      int64_t i) {
  const float y = merge((exps_word >> (8 * (k & 3))) & 0xFFu,
                        (sign_bits >> k) & 1u);
  return weights != nullptr ? __fmul_rn(y, weights[i]) : y;
}

// sum_i terms of the kGroup elements of group g, clients in order; the
// accumulator starts as client 0's term, as XLA simplifies the
// reference's 0 + y to y (a -0.0 stays -0.0)
__device__ __forceinline__ void reduce_group(
    const uint8_t* __restrict__ exps, const uint8_t* __restrict__ signs,
    const float* __restrict__ weights, int64_t n, int64_t total, int64_t g,
    float acc[kGroup]) {
  for (int64_t i = 0; i < n; ++i) {
    const uint4 e = reinterpret_cast<const uint4*>(exps + i * total)[g];
    const uint32_t s =
        reinterpret_cast<const uint16_t*>(signs + i * (total / 8))[g];
    const uint32_t words[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const float y = term(words[k >> 2], s, k, weights, i);
      acc[k] = i == 0 ? y : __fadd_rn(acc[k], y);
    }
  }
}

// Each warp owns 32 consecutive groups of 16 elements and writes their 512
// float32 sums through a shared-memory stage, so that each float4 store
// instruction of the warp covers 512 contiguous bytes (qsgd.cu's stage).
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

// total % 16 == 0: exps (n, total) u8 read 16 codes at a time, signs
// (n, total / 8) 2 bytes at a time -> out (total) f32
__global__ void __launch_bounds__(kThreads)
natural_reduce_group_kernel(const uint8_t* __restrict__ exps,
                            const uint8_t* __restrict__ signs,
                            const float* __restrict__ weights,
                            float* __restrict__ out, int64_t n,
                            int64_t total) {
  __shared__ float4 stage[kThreads / 32][32 * kGroup / 4];
  const int lane = threadIdx.x & 31;
  const int64_t groups = total / kGroup;
  const int64_t warp =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t w0 = warp * 32; w0 < groups; w0 += warps * 32) {
    const int64_t g = w0 + lane;
    float acc[kGroup];
    if (g < groups) reduce_group(exps, signs, weights, n, total, g, acc);
    store_groups(stage[threadIdx.x >> 5], reinterpret_cast<float4*>(out), acc,
                 w0, groups);
  }
}

// any total % 8 == 0: one float4 per thread, a 4-byte exponent load and
// the sign nibble per client
__global__ void __launch_bounds__(kThreads)
natural_reduce_quad_kernel(const uint32_t* __restrict__ exps,
                           const uint8_t* __restrict__ signs,
                           const float* __restrict__ weights,
                           float4* __restrict__ out, int64_t n,
                           int64_t quads) {
  for (int64_t q = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       q < quads; q += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const uint32_t shift = static_cast<uint32_t>(q & 1) * 4u;
    float acc[4];
    for (int64_t i = 0; i < n; ++i) {
      const uint32_t e = exps[i * quads + q];
      const uint32_t s =
          static_cast<uint32_t>(signs[i * (quads / 2) + (q >> 1)]) >> shift;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float y = term(e, s, k, weights, i);
        acc[k] = i == 0 ? y : __fadd_rn(acc[k], y);
      }
    }
    out[q] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) % a) == 0;
}

// blocks of kThreads for one thread per unit, at most one wave
unsigned int blocks_for(int64_t units) {
  int64_t blocks = (units + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned int>(blocks);
}

}  // namespace

extern "C" {

// x (n, total) f32 -> exps (n, total) u8, signs (n, total / 8) u8; seeds
// (n, 2) u32 on the device; total % 8 == 0, x 16-byte and exps 4-byte
// aligned.  Returns the cudaError_t of the launch.
int natural_pack(const float* x, uint8_t* exps, uint8_t* signs,
                 const uint32_t* seeds, int64_t n, int64_t total,
                 void* stream) {
  if (total % 8 != 0 || n < 1 || n > 65535 || !aligned(x, 16) ||
      !aligned(exps, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t quads = total / 4;
  const dim3 grid(blocks_for(quads), static_cast<unsigned int>(n));
  natural_pack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<uint32_t*>(exps),
      signs, seeds, quads);
  return static_cast<int>(cudaGetLastError());
}

// x (total) f32 -> out (total) f32, one seed pair; total % 8 == 0, both
// 16-byte aligned
int natural_fused(const float* x, float* out, uint32_t s0, uint32_t s1,
                  int64_t total, void* stream) {
  if (total % 8 != 0 || !aligned(x, 16) || !aligned(out, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t quads = total / 4;
  natural_fused_kernel<<<blocks_for(quads), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out), s0,
      s1, quads);
  return static_cast<int>(cudaGetLastError());
}

// exps (n, total) u8, signs (n, total / 8) u8, weights (n) f32 or null ->
// out (total) f32; total % 8 == 0, exps 4-byte and out 16-byte aligned
int natural_reduce(const uint8_t* exps, const uint8_t* signs,
                   const float* weights, float* out, int64_t n, int64_t total,
                   void* stream) {
  if (total % 8 != 0 || n < 1 || !aligned(exps, 4) || !aligned(out, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (total % kGroup == 0 && aligned(exps, 16) && aligned(signs, 2)) {
    natural_reduce_group_kernel<<<blocks_for(total / kGroup), kThreads, 0,
                                  st>>>(exps, signs, weights, out, n, total);
  } else {
    natural_reduce_quad_kernel<<<blocks_for(total / 4), kThreads, 0, st>>>(
        reinterpret_cast<const uint32_t*>(exps), signs, weights,
        reinterpret_cast<float4*>(out), n, total / 4);
  }
  return static_cast<int>(cudaGetLastError());
}

// x (total) float32 (bf16 == 0) or bfloat16, u (total) float32 -> out
// (total) of x's type
int natural_compress_2d(const void* x, const float* u, void* out,
                        int64_t total, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    natural_noise_kernel<__nv_bfloat16><<<blocks_for(total), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), u,
        static_cast<__nv_bfloat16*>(out), total);
  } else if (total % 4 == 0 && aligned(x, 16) && aligned(u, 16) &&
             aligned(out, 16)) {
    natural_noise_quad_kernel<<<blocks_for(total / 4), kThreads, 0, st>>>(
        static_cast<const float4*>(x), reinterpret_cast<const float4*>(u),
        static_cast<float4*>(out), total / 4);
  } else {
    natural_noise_kernel<float><<<blocks_for(total), kThreads, 0, st>>>(
        static_cast<const float*>(x), u, static_cast<float*>(out), total);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
