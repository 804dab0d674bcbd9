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
// ridge: the kernel is bound by operations.  On the CUDA cores in float32
// (67 TFLOP/s) that bound is 2.05 ms; this design runs the products on
// the tensor cores in TF32 (495 TFLOP/s dense) at three passes each.
//
// Design:
//   * Split-TF32 products on the tensor cores.  A TF32 operand keeps 10
//     of float32's 23 mantissa bits: one pass misses the float32
//     tolerance by about 60x.  Each float32 operand x is split into
//     big = tf32(x) and small = tf32(x - big) (x - big is exact), both
//     rounded to nearest with ties away from zero, as cvt.rna.tf32.f32
//     rounds a finite value, in two integer operations (see split), and
//     a product takes three MMAs into a float32 accumulator, smallest
//     terms first: small.big + big.small + big.big (small.small, ~2^-22
//     relative, is dropped).  bf16 q, k, v are exact in TF32: Q K^T takes
//     one pass and P V two (only P splits).  The tensor cores truncate
//     as they accumulate, so a tile's P V starts from zero and joins the
//     row's accumulator by float32 operations (acc = acc * alpha + pv):
//     accumulating P V across all 4096 keys in the MMA's accumulator
//     left the prefill shape 1.06e-5 from the plain version, per tile
//     2.38e-6 (H100 80GB HBM3, 700 W).
//   * The MMA is mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 (warp
//     level, operands in registers).  wgmma would need both TF32 operands
//     K-major in shared memory (V transposed) and the split operands
//     staged there too; mma.sync takes the split fragments straight from
//     registers, and P straight from the accumulator (below).
//   * A warp owns MT x 16 query rows (MT m-tiles of the MMA) and walks
//     every KV tile of its block: S (16 x BK a m-tile) lives in C
//     fragments, the softmax runs on them in registers (row max and row
//     sum across the four lanes of a row by xor shuffles 1, 2, in that
//     order), and P goes to the A operand of P V without a trip through
//     shared memory: a C fragment holds keys 2t, 2t+1 of each 8-key
//     group, an A fragment keys t, t+4, so P V relabels the keys of a
//     group (A column t is key 2t, column t+4 key 2t+1) and reads V's
//     rows in the same order.  The sum over keys does not depend on
//     their labels.
//   * K and V tiles are staged raw (float32 or bf16) in a ring of
//     kStages = 2 shared-memory buffers filled by cp.async: the next
//     tile's copy is in flight while this tile's MMAs run.  Q is staged
//     once.  Rows are padded by 16 bytes (LD = D + 4 floats or D + 8
//     bf16), which makes every fragment load of Q, K and V free of bank
//     conflicts.  Operands are split where a fragment is loaded.
//   * Tiles per head dim (Tile<T, D>): D = 64 runs 4 warps of MT = 2
//     (BQ = 128 query rows) and BK = 64 keys, 104 KB of shared memory in
//     float32, two blocks an SM; D = 128 and 256 run 4 warps of MT = 1
//     (BQ = 64) and BK = 32, so that two stages fit the 227 KB of a block
//     (static_asserts hold both), and P V in passes of 8 n-tiles of the
//     output, so that the tile's accumulator stays in registers.  At
//     D = 64 the warps and m-tiles were chosen by measurement
//     (kWarps64 x kMTiles64, tools/probe_kernels.py; H100 80GB HBM3,
//     700 W, prefill shape): 4 x 2 ran 2.77-2.84 ms, 4 x 1 3.36 and
//     8 x 1 3.45 (more warps an SM, but half the use of each split K
//     and V fragment).
//   * Softmax masks only in tiles that cross the causal diagonal, the
//     window's edge or T; the others take the scaled scores as they are.
//   * Grid (query tiles, batch * heads).  The TPU's sequential kv grid
//     axis, whose VMEM scratch carried m, l and acc from step to step,
//     becomes a loop over KV tiles inside the block.  Query tiles are
//     issued last-first, so the causal tiles with the most work start
//     first.
//   * GQA: query head h reads KV head h / (H / Kv) in place, from the
//     (B, S, H, D) / (B, T, Kv, D) layout with the caller's strides (the
//     last axis contiguous): no repeat and no transposed copies.
//   * Ragged edges: any S, T >= 1.  Query rows past S are computed on zero
//     inputs and not stored; keys past T are zero-filled by cp.async and
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
//   * expf (not __expf); the library is built with --fmad=false for the
//     other kernels' bit-exact contracts (this kernel's is a tolerance).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;  // the reference's NEG_INF
constexpr int kWarps64 = 4;    // D = 64: warps a block and m-tiles a
constexpr int kMTiles64 = 2;   // warp, chosen by measurement (Tiles)
constexpr int kStages = 2;                 // K / V ring depth
constexpr int kSmemPerBlock = 227 * 1024;  // Hopper, dynamic shared memory

template <typename T, int D>
struct Tile {
  static_assert(D % 64 == 0, "head dim");
  static constexpr int WARPS = D == 64 ? kWarps64 : 4;
  static constexpr int kThreads = 32 * WARPS;
  static constexpr int MT = D == 64 ? kMTiles64 : 1;  // m-tiles a warp
  static constexpr int BQ = WARPS * 16 * MT;    // query rows of a block
  static constexpr int BK = D == 64 ? 64 : 32;  // keys of a KV tile
  static constexpr int LD = D + 16 / (int)sizeof(T);  // staged row stride
  static constexpr int QLD = D + 4;                    // Q rows (float32)
  static constexpr int NT = BK / 8;   // n-tiles of S, k-steps of P V
  static constexpr int DT = D / 8;    // k-steps of Q K^T, n-tiles of O
  static constexpr int DC = DT < 8 ? DT : 8;  // n-tiles of O a P V pass
  static constexpr int kSmem = BQ * QLD * (int)sizeof(float) +
                               kStages * 2 * BK * LD * (int)sizeof(T);
};
static_assert(Tile<float, 64>::kSmem <= kSmemPerBlock / 2,
              "two D = 64 blocks must fit an SM");
static_assert(Tile<float, 256>::kSmem <= kSmemPerBlock,
              "the D = 256 tiles must fit a block's shared memory");

struct Strides {  // in elements; the last axis is contiguous
  int64_t qb, qs, qh, kb, kt, kh, vb, vt, vh;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16_rn(a);
  v.y = __float2bfloat16_rn(b);
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

// x rounded to TF32 as an MMA operand, to nearest with ties away from
// zero (cvt.rna.tf32.f32 for finite x): half a TF32 ulp added to the bits.
// The MMA reads only the top 19 bits of a .tf32 register, so the low 13
// need no mask (cvt.rna's own code feeds the unmasked sum to the MMA
// too, after a test for Inf and NaN that finite operands do not need).
__device__ __forceinline__ uint32_t tf32_operand(float x) {
  return __float_as_uint(x) + 0x1000u;
}

struct Split {
  uint32_t big, small;
};

// x = big + small + O(2^-22 |x|): big = tf32(x) exactly (masked, as
// x - big needs it), small = tf32(x - big), x - big being exact.  Inputs
// exact in TF32 (bf16) pass as they are, small = 0.
template <bool kSplit>
__device__ __forceinline__ Split split(float x) {
  if (!kSplit) return {__float_as_uint(x), 0u};
  const uint32_t big = tf32_operand(x) & 0xFFFFE000u;
  return {big, tf32_operand(__fsub_rn(x, __uint_as_float(big)))};
}

// c += a . b on the tensor cores, one m16n8k8 TF32 MMA
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += A . B from split operands: small.big + big.small + big.big
// (the first term only when A splits, the second only when B does)
template <bool kSplitA, bool kSplitB>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  if (kSplitA) mma(c, as, bb);
  if (kSplitB) mma(c, ab, bs);
  mma(c, ab, bb);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// 16-byte asynchronous copy global -> shared; src_bytes = 0 zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// rows [0, ROWS) of a (ROWS, D) tile into shared memory (row stride LD);
// rows at or past `valid` are zero-filled
template <typename T, int D, int ROWS, int LD, int kThreads>
__device__ __forceinline__ void stage_async(T* dst, const T* src,
                                            int64_t stride, int valid) {
  constexpr int C = D * (int)sizeof(T) / 16;  // 16-byte chunks a row
  constexpr int E = 16 / (int)sizeof(T);      // elements a chunk
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * C; i += kThreads) {
    const int r = i / C, c = i % C;
    const bool in = r < valid;
    cp_async16(dst + r * LD + c * E, in ? src + r * stride + c * E : src,
               in ? 16 : 0);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Tile<T, D>::kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int S, int Tk, int H,
          int group, Strides st, int causal, int window, float scale) {
  using L = Tile<T, D>;
  constexpr int MT = L::MT, BQ = L::BQ, BK = L::BK, LD = L::LD;
  constexpr int QLD = L::QLD, NT = L::NT, DT = L::DT, DC = L::DC;
  constexpr int kThreads = L::kThreads;
  constexpr bool kSplit = sizeof(T) == 4;  // float32 operands split
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  T* KVs = reinterpret_cast<T*>(Qs + BQ * QLD);  // [stage][K, V][BK][LD]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // MMA fragment row and column
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / group;
  const T* kb = k + b * st.kb + kvh * st.kh;
  const T* vb = v + b * st.vb + kvh * st.vh;

  // KV tiles to visit (see "Tile skipping" above)
  const int q_last = min(q0 + BQ, S) - 1;
  int kt_begin = 0, kt_end = (Tk + BK - 1) / BK;
  if (window <= 0 || q_last - (Tk - 1) < window) {
    if (causal) kt_end = min(kt_end, q_last / BK + 1);
    if (window > 0) kt_begin = max(0, q0 - window + 1) / BK;
  }

  auto stage_kv = [&](int kt, int buf) {
    T* Ks = KVs + buf * 2 * BK * LD;
    const int k0 = kt * BK;
    stage_async<T, D, BK, LD, kThreads>(Ks, kb + k0 * st.kt, st.kt, Tk - k0);
    stage_async<T, D, BK, LD, kThreads>(Ks + BK * LD, vb + k0 * st.vt, st.vt,
                                        Tk - k0);
    cp_async_commit();
  };
  if (kt_begin < kt_end) stage_kv(kt_begin, 0);

  // Q once, widened to float32 (rows past S are zero)
  {
    const T* qb = q + b * st.qb + h * st.qh + q0 * st.qs;
    for (int i = threadIdx.x; i < BQ * D / 2; i += kThreads) {
      const int r = i / (D / 2), c = 2 * (i % (D / 2));
      float x0 = 0.f, x1 = 0.f;
      if (q0 + r < S) {
        x0 = widen(qb[r * st.qs + c]);
        x1 = widen(qb[r * st.qs + c + 1]);
      }
      Qs[r * QLD + c] = x0;
      Qs[r * QLD + c + 1] = x1;
    }
  }

  float m[MT][2], l[MT][2], acc[MT][DT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mi][r] = kMasked;
      l[mi][r] = 0.f;
    }
#pragma unroll
    for (int dn = 0; dn < DT; ++dn)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][dn][c] = 0.f;
  }
  const float* Qw = Qs + warp * 16 * MT * QLD;
  const int row0 = q0 + warp * 16 * MT + g;  // fragment row (+8, +16 mi)

  for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
    const int buf = it % kStages;
    if (kt + 1 < kt_end) {
      stage_kv(kt + 1, (it + 1) % kStages);  // in flight during this tile
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile's K and V (and Q) are in shared memory
    const T* Ks = KVs + buf * 2 * BK * LD;
    const T* Vs = Ks + BK * LD;
    const int k0 = kt * BK;

    // S = Q K^T: A = Q rows (16 x 8 of d), B = K rows as columns
    float s[MT][NT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[mi][j][c] = 0.f;
#pragma unroll 2
    for (int d0 = 0; d0 < D; d0 += 8) {
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const float* qr = Qw + (mi * 16 + g) * QLD + d0 + t;
        const float x[4] = {qr[0], qr[8 * QLD], qr[4], qr[8 * QLD + 4]};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const Split sp = split<kSplit>(x[c]);
          ab[mi][c] = sp.big;
          as[mi][c] = sp.small;
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const T* kr = Ks + (8 * j + g) * LD + d0 + t;
        const Split s0 = split<kSplit>(widen(kr[0]));
        const Split s1 = split<kSplit>(widen(kr[4]));
        const uint32_t bb[2] = {s0.big, s1.big}, bs[2] = {s0.small, s1.small};
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
          mma3<kSplit, kSplit>(s[mi][j], ab[mi], as[mi], bb, bs);
      }
    }

    // scale, mask, online softmax on the C fragments: s[mi][j][c] is row
    // row0 + 16 mi + 8 (c >> 1), key k0 + 8 j + 2 t + (c & 1).  Only
    // tiles that cross the diagonal, the window's edge or T test keys.
    const bool edge = (causal && k0 + BK - 1 > q0) || k0 + BK > Tk ||
                      (window > 0 && q_last - k0 >= window);
    float alpha[MT][2];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 16 * mi + 8 * r;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * j + 2 * t + e;
            float x = __fmul_rn(s[mi][j][2 * r + e], scale);
            if (edge) {
              if (key >= Tk)
                x = -INFINITY;  // padding past T: contributes nothing
              else if ((causal && key > row) ||
                       (window > 0 && row - key >= window))
                x = kMasked;
            }
            s[mi][j][2 * r + e] = x;
            mx = fmaxf(mx, x);
          }
        const float m_cur = fmaxf(m[mi][r], quad_max(mx));
        alpha[mi][r] = expf(__fsub_rn(m[mi][r], m_cur));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = expf(__fsub_rn(s[mi][j][2 * r + e], m_cur));
            s[mi][j][2 * r + e] = p;
            sum = __fadd_rn(sum, p);
          }
        l[mi][r] = __fadd_rn(__fmul_rn(l[mi][r], alpha[mi][r]),
                             quad_sum(sum));
        m[mi][r] = m_cur;
      }
    }

    // pv = P V.  k-step j takes P's n-tile j as the A operand: column t
    // is key 2t, column t + 4 key 2t + 1 (the C fragment's own keys), and
    // B reads V's rows 8 j + 2 t and 8 j + 2 t + 1 to match.  The tile's
    // product starts from zero and joins acc by float32 operations,
    // acc = acc * alpha + pv, as in the reference: the tensor cores'
    // accumulation (truncating) spans one tile, not the whole row.
    // Passes of DC n-tiles keep pv's registers bounded at D = 128, 256.
#pragma unroll
    for (int d0n = 0; d0n < DT; d0n += DC) {
      float pv[MT][DC][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int dn = 0; dn < DC; ++dn)
#pragma unroll
          for (int c = 0; c < 4; ++c) pv[mi][dn][c] = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t pb[MT][4], ps[MT][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const float x[4] = {s[mi][j][0], s[mi][j][2], s[mi][j][1],
                              s[mi][j][3]};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const Split sp = split<true>(x[c]);
            pb[mi][c] = sp.big;
            ps[mi][c] = sp.small;
          }
        }
        const T* vr = Vs + (8 * j + 2 * t) * LD + 8 * d0n + g;
#pragma unroll
        for (int dn = 0; dn < DC; ++dn) {
          const Split s0 = split<kSplit>(widen(vr[8 * dn]));
          const Split s1 = split<kSplit>(widen(vr[LD + 8 * dn]));
          const uint32_t bb[2] = {s0.big, s1.big};
          const uint32_t bs[2] = {s0.small, s1.small};
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
            mma3<true, kSplit>(pv[mi][dn], pb[mi], ps[mi], bb, bs);
        }
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int dn = 0; dn < DC; ++dn)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[mi][d0n + dn][c] =
                __fadd_rn(__fmul_rn(acc[mi][d0n + dn][c], alpha[mi][c >> 1]),
                          pv[mi][dn][c]);
    }
    __syncthreads();  // the buffer is refilled two tiles from now
  }

  // out = acc / max(l, 1e-30), IEEE division, one rounding to T
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * mi + 8 * r;
      if (row >= S) continue;
      const float den = fmaxf(l[mi][r], 1e-30f);
      T* orow = o + (((int64_t)b * S + row) * H + h) * D + 2 * t;
#pragma unroll
      for (int dn = 0; dn < DT; ++dn)
        store2(orow + 8 * dn, __fdiv_rn(acc[mi][dn][2 * r], den),
               __fdiv_rn(acc[mi][dn][2 * r + 1], den));
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
  using L = Tile<T, D>;
  auto kernel = flash_fwd<T, D>;
  // above 48 KB only as dynamic shared memory, after this opt-in
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + L::BQ - 1) / L::BQ, a.B * a.H);
  kernel<<<grid, L::kThreads, L::kSmem, stream>>>(
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
