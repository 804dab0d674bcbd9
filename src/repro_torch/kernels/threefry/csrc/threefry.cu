// Threefry-2x32 array draws for Hopper (sm_90a): the counter hash behind
// repro_torch.core.prng's tensor_bits, tensor_uniform and tensor_bernoulli
// (and tensor_normal's uniform), one launch a draw.  Plain C interface,
// loaded with ctypes by repro_torch/kernels/threefry/kernel.py.
//
// Replaces no TPU kernel: the reference draws the leafwise codecs' noise
// with XLA's jax.random (threefry2x32, partitionable counters), which XLA
// fuses on its own.  The port drew the same bits as plain PyTorch int64
// elementwise passes (core/prng.py, _threefry_tensor), about 120 launches
// for every chunk of 2^22 counters, each pass reading and writing its
// int64 words in device memory.
//
// Bound: integer throughput.  A counter costs 73 32-bit integer
// operations in the block (two key adds, 20 rounds of add, rotate and
// xor, five key injections of two adds each, the final xor), and its
// output is 4 bytes (float32 uniform; 8 for the int64 bits, 1 for a
// bernoulli bool).  Its 20 rotations (funnel shifts) and 21 xors run
// only on an SM's INT32 pipe, 64 lanes a clock; nvcc moves the adds to
// the FMA pipe as IMAD, so those 41 operations set the pace: at 64 x 132
// SMs x 1.98 GHz (16.7e12 a second) a counter takes 2.45 ps against 1.2
// ps to write 4 bytes at 3.35 TB/s, twice the memory's time.  (All 73
// operations at 64 lanes, 4.4 ps a counter, are no bound: this kernel
// ran under it on an H100.)
//
// Design, for that bound:
//   * Every counter is hashed once, in registers, and its finished value
//     written once: no int64 word, no temporary and no chunk loop ever
//     reaches device memory, so the memory side stays at its 4 bytes.
//   * The key schedule (k1 ^ k2 ^ parity and each injection's key plus
//     its round number) is formed once a batch row, not once a counter;
//     each rotation is one funnel shift (__funnelshift_l), and the native
//     uint32 arithmetic wraps, so nothing is masked.
//   * A grid-stride loop over the counters of each batch row (blockIdx.y
//     walks the rows), with as many blocks as fill every SM at the
//     kernel's occupancy: the integer pipes of all 132 SMs stay busy and
//     the loop's bookkeeping is paid once for kPerThread counters.  A
//     thread's kPerThread counters lie kThreads apart, so every store of
//     a warp is one contiguous run.
//   * Counter j of a row is the 64-bit offset + j, its high word the
//     block's first counter word and its low word the second, as
//     jax.random.bits splits its iota; the output word is y1 ^ y2.  The finish is a template argument:
//     the word widened to int64 (bits), (word >> 9) * 2^-23, exact in
//     float32 (uniform), or that uniform < p as a bool (bernoulli).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;       // counters a thread hashes a pass
constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr int kBits = 0, kUniform = 1, kBernoulli = 2;   // the finishes
constexpr int kMaxDevices = 64;

// one round of threefry2x32: add, rotate left by r, xor
__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
}

__device__ __forceinline__ void four(uint32_t& x0, uint32_t& x1, int r0,
                                     int r1, int r2, int r3) {
  mix(x0, x1, r0);
  mix(x0, x1, r1);
  mix(x0, x1, r2);
  mix(x0, x1, r3);
}

// a batch row's key schedule: ks[0..2] and the five injections into x1,
// ks[(i + 2) % 3] + (i + 1)
struct Schedule {
  uint32_t k0, k1, k2, i1, i2, i3, i4, i5;
};

__device__ __forceinline__ Schedule schedule(uint32_t k0, uint32_t k1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  return {k0, k1, k2, k2 + 1u, k0 + 2u, k1 + 3u, k2 + 4u, k0 + 5u};
}

// y1 ^ y2 of the 20-round block on counter words (x0, x1) = (hi, lo)
__device__ __forceinline__ uint32_t threefry_xor(const Schedule& s,
                                                 uint32_t x0, uint32_t x1) {
  x0 += s.k0;
  x1 += s.k1;
  four(x0, x1, 13, 15, 26, 6);
  x0 += s.k1;
  x1 += s.i1;
  four(x0, x1, 17, 29, 16, 24);
  x0 += s.k2;
  x1 += s.i2;
  four(x0, x1, 13, 15, 26, 6);
  x0 += s.k0;
  x1 += s.i3;
  four(x0, x1, 17, 29, 16, 24);
  x0 += s.k1;
  x1 += s.i4;
  four(x0, x1, 13, 15, 26, 6);
  x0 += s.k2;
  x1 += s.i5;
  return x0 ^ x1;
}

template <int MODE>
__device__ __forceinline__ void finish(void* out, int64_t i, uint32_t bits,
                                       float p) {
  if constexpr (MODE == kBits) {
    static_cast<int64_t*>(out)[i] = static_cast<int64_t>(bits);
  } else {
    // the top 23 bits times 2^-23: exact, as prng._to_uniform
    const float u = __fmul_rn(__uint2float_rn(bits >> 9),
                              1.1920928955078125e-07f);
    if constexpr (MODE == kUniform) {
      static_cast<float*>(out)[i] = u;
    } else {
      static_cast<uint8_t*>(out)[i] = u < p ? 1 : 0;
    }
  }
}

template <int MODE>
__device__ __forceinline__ void draw_one(const Schedule& s, void* out,
                                         int64_t row, uint64_t offset,
                                         int64_t j, float p) {
  const uint64_t c = offset + static_cast<uint64_t>(j);
  finish<MODE>(out, row + j,
               threefry_xor(s, static_cast<uint32_t>(c >> 32),
                            static_cast<uint32_t>(c)),
               p);
}

// keys (batch, 2) uint32 -> out (batch, total) of the finish's type
template <int MODE>
__global__ void __launch_bounds__(kThreads)
threefry_kernel(const uint32_t* __restrict__ keys, void* __restrict__ out,
                int64_t batch, int64_t total, uint64_t offset, float p) {
  const int64_t span = static_cast<int64_t>(kThreads) * kPerThread;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * span;
  for (int64_t b = blockIdx.y; b < batch; b += gridDim.y) {
    const Schedule s = schedule(keys[2 * b], keys[2 * b + 1]);
    const int64_t row = b * total;
    for (int64_t base = blockIdx.x * span + threadIdx.x; base < total;
         base += stride) {
      if (base + (kPerThread - 1) * kThreads < total) {
#pragma unroll
        for (int u = 0; u < kPerThread; ++u)
          draw_one<MODE>(s, out, row, offset, base + u * kThreads, p);
      } else {
        for (int64_t j = base; j < total; j += kThreads)
          draw_one<MODE>(s, out, row, offset, j, p);
      }
    }
  }
}

// resident blocks an SM times the SMs, a device and finish, found once
cudaError_t filling_blocks(int mode, int* fill) {
  static int cached[kMaxDevices][3];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[dev][mode] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const void* fn =
        mode == kBits      ? reinterpret_cast<const void*>(threefry_kernel<kBits>)
        : mode == kUniform ? reinterpret_cast<const void*>(threefry_kernel<kUniform>)
                           : reinterpret_cast<const void*>(threefry_kernel<kBernoulli>);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                        0);
    if (err != cudaSuccess) return err;
    cached[dev][mode] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *fill = cached[dev][mode];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// keys (batch, 2) uint32 on the device; out (batch, total): int64 (mode
// 0, bits), float32 (1, uniform) or bool (2, bernoulli against p).  Row
// b's element j hashes counter offset + j with key row b; the caller
// keeps offset + total <= 2^64.  Returns the cudaError_t of the launch.
int threefry_draw(const uint32_t* keys, void* out, int64_t batch,
                  int64_t total, uint64_t offset, int mode, float p,
                  void* stream) {
  if (batch < 0 || total < 0 || mode < kBits || mode > kBernoulli)
    return cudaErrorInvalidValue;
  if (batch == 0 || total == 0) return cudaSuccess;
  int fill = 0;
  const cudaError_t err = filling_blocks(mode, &fill);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t span = static_cast<int64_t>(kThreads) * kPerThread;
  const unsigned int gy =
      static_cast<unsigned int>(batch < 65535 ? batch : 65535);
  int64_t gx = (total + span - 1) / span;
  const int64_t share = (fill + gy - 1) / gy;
  if (gx > share) gx = share;
  const dim3 grid(static_cast<unsigned int>(gx), gy);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kBits)
    threefry_kernel<kBits><<<grid, kThreads, 0, st>>>(keys, out, batch, total,
                                                      offset, p);
  else if (mode == kUniform)
    threefry_kernel<kUniform><<<grid, kThreads, 0, st>>>(keys, out, batch,
                                                         total, offset, p);
  else
    threefry_kernel<kBernoulli><<<grid, kThreads, 0, st>>>(keys, out, batch,
                                                           total, offset, p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
