// Gaussian noise from counter-based threefry-2x32 bits, written for Hopper
// (sm_90a): the hash, the mantissa map to a uniform and XLA's float32
// erf_inv in one pass, nothing in between kept in device memory.
//
// Not a TPU kernel: the JAX package draws this noise with jnp, and XLA
// fuses the hash and the bits -> normal map into one elementwise fusion
// (src/repro/md/noise.py:109 step_noise_unrolled through :47
// threefry2x32_unrolled and :68 _bits_to_normal; jax.random.normal(
// fold_in(k, t)) in src/repro/md/integrators.py:218 stacked_step_noise;
// p + std * normal(k) in src/repro/optim/sgld.py).  Eager PyTorch runs the
// same hash as ~600 small launches a draw (kernels/noise/ref.py).  Three
// entry points, each bitwise its plain version:
//   noise_unrolled_launch  the fused propagate's legacy layout: replica r
//     folds t into its key, threefry(k, (0, t)), and hashes the counter
//     pair (i, i + half) into outputs i and i + half (an odd size pads the
//     second half with one zero counter);
//   noise_stacked_launch   the partitionable layout, every step at once:
//     out[s, r, j] from fold_in(k_r, s) and the 64-bit flat index j split
//     into (hi, lo) counters, bits b1 ^ b2;
//   sgld_noise_launch      the partitionable layout from a flat index
//     offset + j, fused into the SGLD update p + std * normal as compiled
//     XLA computes it: fma(erf_inv(u), std * sqrt 2, p), std read from
//     device memory (no host sync).
// and noise_map_launch, the bits -> erf_inv map alone on given words,
// which chip_smoke.py runs on all 2^23 mantissas.
//
// Arithmetic, step for step the plain version (random.py): the library is
// built with -fmad=false, so no float multiply and add is contracted into
// an FMA (the plain _log, _log1p and _sqrt depend on which steps are
// FMAs); the plain version's FMAs are float32 FMAs on the FP32 pipes
// (__fmaf_rn, rounded once, as XLA's CPU FMA rounds).  The plain version
// emulates them in float64 and rounds twice, to double and then to float;
// the two roundings agree on every FMA of the map over all 2^23 inputs
// the map reads (tests/test_torch_noise_map.py counts the ties), so the
// map is bitwise the plain one there.  Two steps stay in float64: _sqrt's
// reciprocal root, CUDA's double rsqrt (the function PyTorch's rsqrt runs
// on the card; only on the w >= 5 tail, ~0.34% of lanes), and the SGLD
// update's last FMA, whose p no exhaustive check covers (fma_f64 below,
// the plain emulation).  Division is IEEE (no fast math).  Constants are
// the plain version's float32 values as hex literals
// (tests/test_torch_noise_kernel.py reads them back).
//
// What bounds it on an H100: integer operations.  A threefry block is ~80
// int32 operations (20 rounds of add, rotate, xor and 5 key injections)
// at 64 a clock an SM; the bits -> normal map ~60 float32 operations at
// 128 a clock.  At R = 64, N = 2,881 and 11 steps the stacked draw writes
// 24 MB (0.007 ms at 3.35 TB/s) and hashes 6.1 M blocks, ~0.03 ms of the
// int32 pipes (PERF.md section 6 gives the measured times, the SASS
// counts and the bounds).
//
// Design: a block of 256 threads.  Where a block's threads share a
// replica and a step (the legacy and stacked layouts), thread 0 folds the
// key once into shared memory and each thread makes one output (one
// counter pair of the legacy layout); 2 or 4 outputs a thread there were
// no faster on an H100 (PERF.md section 6).  The SGLD update takes 4
// consecutive elements a thread, one 16-byte load of p and one store
// where both pointers allow (7% faster than one a thread).
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
// elements a thread of the SGLD update
constexpr int kPer = 4;

// random.py constants, float32 values
constexpr float kNormalLo = -0x1.fffffep-1f;   // nextafter(-1, 0)
constexpr float kSpan = 0x1.0p+1f;             // float32(1 - lo)
constexpr float kSqrt2 = 0x1.6a09e6p+0f;
constexpr float kSqrtHalf = 0x1.6a09e6p-1f;
constexpr float kLog1pSplit = 0x1.a8279ap-2f;  // float32(sqrt(2) - 1)
constexpr float kLogQ1 = -0x1.bd0106p-13f;
constexpr float kLogQ2 = 0x1.63p-1f;
// LOG_P
__constant__ float kLogP[9] = {
    0x1.204376p-4f, -0x1.d7a37p-4f, 0x1.de4a34p-4f, -0x1.fcba9ep-4f,
    0x1.23d37ep-3f, -0x1.555ca0p-3f, 0x1.999d58p-3f, -0x1.fffff8p-3f,
    0x1.555554p-2f};
// LOG1P_NUM
__constant__ float kLog1pNum[7] = {
    0x1.7bc096p-15f, 0x1.fe818ap-2f, 0x1.a509f4p+2f, 0x1.de9738p+4f,
    0x1.e798ecp+5f, 0x1.c8e75ap+5f, 0x1.40a202p+4f};
// LOG1P_DEN
__constant__ float kLog1pDen[7] = {
    0x1.0p+0f, 0x1.e2035ap+3f, 0x1.4c30b6p+6f, 0x1.bb865ap+7f,
    0x1.351946p+8f, 0x1.b0db14p+7f, 0x1.e0f304p+5f};
// ERFINV_LT5
__constant__ float kErfInvLt5[9] = {
    0x1.e2cb10p-26f, 0x1.70966cp-22f, -0x1.d8e6aep-19f, -0x1.26b582p-18f,
    0x1.ca65b6p-13f, -0x1.48a810p-10f, -0x1.11c9dep-8f, 0x1.f91ec6p-3f,
    0x1.805c5ep+0f};
// ERFINV_GE5
__constant__ float kErfInvGe5[9] = {
    -0x1.a3e136p-13f, 0x1.a76ad6p-14f, 0x1.61b8e4p-10f, -0x1.e17bcep-9f,
    0x1.7824f6p-8f, -0x1.f38baep-8f, 0x1.354afcp-7f, 0x1.006db6p+0f,
    0x1.6a9efcp+1f};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry-2x32, 20 rounds: random.py threefry2x32
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t x0, uint32_t x1,
                                         uint32_t& y0, uint32_t& y1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int r0 = i % 2 ? 17 : 13, r1 = i % 2 ? 29 : 15;
    const int r2 = i % 2 ? 16 : 26, r3 = i % 2 ? 24 : 6;
    x0 += x1; x1 = rotl(x1, r0) ^ x0;
    x0 += x1; x1 = rotl(x1, r1) ^ x0;
    x0 += x1; x1 = rotl(x1, r2) ^ x0;
    x0 += x1; x1 = rotl(x1, r3) ^ x0;
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  y0 = x0;
  y1 = x1;
}

// random._fma as the plain version emulates it: the exact double product
// plus c rounded to double, then to float (the SGLD update's last step)
__device__ __forceinline__ float fma_f64(float a, float b, float c) {
  return static_cast<float>(static_cast<double>(a) * static_cast<double>(b)
                            + static_cast<double>(c));
}

// random._log, positive normal x
__device__ __forceinline__ float xla_log(float x) {
  int ei;
  float m = frexpf(x, &ei);
  float e = static_cast<float>(ei);
  const bool small = m < kSqrtHalf;
  e = e - (small ? 1.0f : 0.0f);
  m = (m - 1.0f) + (small ? m : 0.0f);
  const float m2 = m * m;
  const float m3 = m2 * m;
  const float y0 = __fmaf_rn(__fmaf_rn(m, kLogP[0], kLogP[1]), m, kLogP[2]);
  const float y1 = __fmaf_rn(__fmaf_rn(m, kLogP[3], kLogP[4]), m, kLogP[5]);
  const float y2 = __fmaf_rn(__fmaf_rn(m, kLogP[6], kLogP[7]), m, kLogP[8]);
  const float y = __fmaf_rn(__fmaf_rn(__fmaf_rn(y0, m3, y1), m3, y2), m3,
                            kLogQ1 * e);
  return ((m - 0.5f * m2) + y) + kLogQ2 * e;
}

// random._log1p, x in (-1, 0]: only the branch torch.where keeps
__device__ __forceinline__ float xla_log1p(float x) {
  if (!(fabsf(x) < kLog1pSplit)) return xla_log(x + 1.0f);
  const float x2 = x * x;
  float num = 0.0f, den = 0.0f;
#pragma unroll
  for (int k = 0; k < 7; ++k) num = __fmaf_rn(num, x, kLog1pNum[k]);
#pragma unroll
  for (int k = 0; k < 7; ++k) den = __fmaf_rn(den, x, kLog1pDen[k]);
  const float rational = num / den;
  return x + (-0.5f * x2 + (x * x2) * rational);
}

// random._sqrt: x rsqrt(x) (CUDA's double rsqrt) and one Newton step
__device__ float xla_sqrt(float x) {
  const float r = static_cast<float>(rsqrt(static_cast<double>(x)));
  const float y = x * r;
  return __fmaf_rn(__fmaf_rn(-y, y, x), 0.5f * r, y);
}

// random.erf_inv on (-1, 1); each coefficient a select of two uniform
// constant-bank reads
__device__ __forceinline__ float erf_inv(float x) {
  const float w0 = -xla_log1p(-x * x);
  const bool lt = w0 < 5.0f;
  const float w = lt ? w0 - 2.5f : xla_sqrt(w0) - 3.0f;
  float p = lt ? kErfInvLt5[0] : kErfInvGe5[0];
#pragma unroll
  for (int k = 1; k < 9; ++k)
    p = __fmaf_rn(p, w, lt ? kErfInvLt5[k] : kErfInvGe5[k]);
  return fabsf(x) == 1.0f ? x * INFINITY : p * x;
}

// random.bits_to_erf_inv: the mantissa trick onto [lo, 1), then erf_inv
__device__ __forceinline__ float bits_to_erf_inv(uint32_t bits) {
  const float floats = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  return erf_inv(fmaxf(__fmaf_rn(floats, kSpan, kNormalLo), kNormalLo));
}

__device__ __forceinline__ float bits_to_normal(uint32_t bits) {
  return kSqrt2 * bits_to_erf_inv(bits);
}

__device__ __forceinline__ void fold_key(const int64_t* key, uint32_t t,
                                         uint32_t* folded) {
  if (threadIdx.x == 0)
    threefry(static_cast<uint32_t>(key[0]), static_cast<uint32_t>(key[1]),
             0u, t, folded[0], folded[1]);
  __syncthreads();
}

// grid (ceil(half / kThreads), R): thread i of replica r hashes the
// counter pair (i, i + half) of fold_in(key_r, t)
__global__ void noise_unrolled_kernel(const int64_t* __restrict__ keys,
                                      uint32_t t, int64_t size, int64_t half,
                                      float* __restrict__ out) {
  __shared__ uint32_t folded[2];
  const int r = blockIdx.y;
  fold_key(keys + 2 * r, t, folded);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= half) return;
  const bool second = i + half < size;
  uint32_t b0, b1;
  threefry(folded[0], folded[1], static_cast<uint32_t>(i),
           second ? static_cast<uint32_t>(i + half) : 0u, b0, b1);
  float* row = out + r * size;
  row[i] = bits_to_normal(b0);
  if (second) row[i + half] = bits_to_normal(b1);
}

__device__ __forceinline__ uint32_t flat_bits(uint32_t k0, uint32_t k1,
                                              uint64_t idx) {
  uint32_t b0, b1;
  threefry(k0, k1, static_cast<uint32_t>(idx >> 32),
           static_cast<uint32_t>(idx), b0, b1);
  return b0 ^ b1;
}

// grid (ceil(size / kThreads), R, S): out[s, r, j] from fold_in(key_r, s)
__global__ void noise_stacked_kernel(const int64_t* __restrict__ keys,
                                     int64_t size, float* __restrict__ out) {
  __shared__ uint32_t folded[2];
  const int r = blockIdx.y, s = blockIdx.z;
  fold_key(keys + 2 * r, static_cast<uint32_t>(s), folded);
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= size) return;
  const int64_t row = static_cast<int64_t>(s) * gridDim.y + r;
  out[row * size + j] = bits_to_normal(flat_bits(folded[0], folded[1], j));
}

// grid ceil(n / (kThreads kPer)): out[j] = fma(erf_inv(u_{offset + j}),
// std sqrt 2, p[j]) for the thread's kPer consecutive j, in one 16-byte
// load and store when ``vec`` (both pointers 16-byte aligned)
__global__ void sgld_noise_kernel(const float* __restrict__ p,
                                  const int64_t* __restrict__ key,
                                  const float* __restrict__ std,
                                  int64_t offset, int64_t n, bool vec,
                                  float* __restrict__ out) {
  const int64_t j0 =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kPer;
  if (j0 >= n) return;
  const float s2 = *std * kSqrt2;
  const uint32_t k0 = static_cast<uint32_t>(key[0]);
  const uint32_t k1 = static_cast<uint32_t>(key[1]);
  const uint64_t base = static_cast<uint64_t>(offset + j0);
  static_assert(kPer == 4, "one float4 a thread");
  if (vec && j0 + kPer <= n) {
    const float4 pv = *reinterpret_cast<const float4*>(p + j0);
    float4 o;
    o.x = fma_f64(bits_to_erf_inv(flat_bits(k0, k1, base)), s2, pv.x);
    o.y = fma_f64(bits_to_erf_inv(flat_bits(k0, k1, base + 1)), s2, pv.y);
    o.z = fma_f64(bits_to_erf_inv(flat_bits(k0, k1, base + 2)), s2, pv.z);
    o.w = fma_f64(bits_to_erf_inv(flat_bits(k0, k1, base + 3)), s2, pv.w);
    *reinterpret_cast<float4*>(out + j0) = o;
    return;
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q)
    if (j0 + q < n)
      out[j0 + q] = fma_f64(bits_to_erf_inv(flat_bits(k0, k1, base + q)),
                            s2, p[j0 + q]);
}

// grid ceil(n / kThreads): out[j] = erf_inv of word bits[j]'s uniform
__global__ void noise_map_kernel(const uint32_t* __restrict__ bits, int64_t n,
                                 float* __restrict__ out) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j < n) out[j] = bits_to_erf_inv(bits[j]);
}

unsigned blocks(int64_t n, int per = 1) {
  const int64_t w = static_cast<int64_t>(kThreads) * per;
  return static_cast<unsigned>((n + w - 1) / w);
}

}  // namespace

// keys (R, 2) int64 words, out (R, size) float32
extern "C" int noise_unrolled_launch(const int64_t* keys, int R,
                                     unsigned t, int64_t size, float* out,
                                     void* stream) {
  if (R == 0 || size == 0) return 0;
  const int64_t half = (size + size % 2) / 2;
  noise_unrolled_kernel<<<dim3(blocks(half), R), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(keys, t, size,
                                                               half, out);
  return static_cast<int>(cudaGetLastError());
}

// keys (R, 2) int64 words, out (S, R, size) float32
extern "C" int noise_stacked_launch(const int64_t* keys, int R, int S,
                                    int64_t size, float* out, void* stream) {
  if (R == 0 || S == 0 || size == 0) return 0;
  noise_stacked_kernel<<<dim3(blocks(size), R, S), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(keys, size,
                                                              out);
  return static_cast<int>(cudaGetLastError());
}

// p, out (n,) float32; key (2,) int64 words; std one float32
extern "C" int sgld_noise_launch(const float* p, const int64_t* key,
                                 const float* std, int64_t offset, int64_t n,
                                 float* out, void* stream) {
  if (n == 0) return 0;
  const bool vec = (reinterpret_cast<uintptr_t>(p) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  sgld_noise_kernel<<<blocks(n, kPer), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(p, key, std,
                                                           offset, n, vec,
                                                           out);
  return static_cast<int>(cudaGetLastError());
}

// bits (n,) 32-bit words, out (n,) float32: erf_inv(u(bits)), the map
// without the hash
extern "C" int noise_map_launch(const uint32_t* bits, int64_t n, float* out,
                                void* stream) {
  if (n == 0) return 0;
  noise_map_kernel<<<blocks(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(bits, n, out);
  return static_cast<int>(cudaGetLastError());
}
