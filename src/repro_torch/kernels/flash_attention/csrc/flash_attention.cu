// Causal / sliding-window attention, forward only, written for Hopper
// (sm_90a): blockwise online softmax over key tiles, float32 inside,
// float32 or bfloat16 in and out, grouped kv heads read in place.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py
//   flash_attention_kernel (pl.pallas_call at :101, body _attn_kernel at
//   :26), called in the model layout through ops.py:29 flash_attention.
//
// What bounds it on an H100: operations.  At the OLMo-1B prefill shape
// (B = 4, S = T = 2048, H = G = 16, D = 128, causal) the function needs
// 4 B H D S (S + 1) / 2 = 6.9e10 operations (two products per kept
// (query, key) pair) against 134 MB of q, k, v and out: 0.069 ms at the
// tensor cores' bf16 rate, 0.040 ms for the bytes.  This kernel runs the
// products as float32 FMAs on the CUDA cores (67 TFLOP/s: 1.03 ms at
// best); bf16 tiles on the tensor cores (mma / wgmma) and TMA are later
// work.
//
// Design: one block per (q-tile of 64 rows, head h, batch b); the q-tiles
// are issued last first, so the long causal rows start early.  Two
// blocks per SM are asked of the register allocator (__launch_bounds__):
// 128 registers a thread instead of 162, a 112-byte spill at D = 128,
// and 5.4 ms instead of 6.2 at the OLMo-1B prefill shape (NVIDIA H100
// 80GB HBM3, 700 W, chip_smoke.py phase 20's timing).  Each query row
// belongs to TPR = max(1, DP / 32) adjacent lanes, each holding 32
// of its DP dims (float4 chunks c = part + TPR i, so the TPR lanes read
// neighbouring banks) of q and of the output accumulator in registers.
// K and V tiles of 32 keys are staged in shared memory as float32 from
// the (B, T, G, D) layout at kv head h / (H / G): no repeat of kv heads,
// no transposes, no padding of D in memory (dims up to DP are zero in
// registers and shared memory).  Per tile: the 32 partial dot products,
// summed across the row's lanes with xor shuffles (every lane gets the
// same sum), scaled by 1 / sqrt(D) with the true D; masked keys (causal,
// window, the tail past T) get -inf, so they add exp(-inf) = 0 while the
// running max m starts at -1e30 and stays finite; then m, the sum l and
// the accumulator are rescaled by exp(m_old - m_new).  The key loop is
// bounded per q-tile by the causal diagonal and the window (the TPU
// kernel's relevant() tile skip as loop bounds).  Out: acc / max(l,
// 1e-30) rounded to the input dtype (round to nearest even); rows past S
// are not stored.  IEEE expf and division, no fast math; no atomics, so
// a launch is bitwise reproducible.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 32;   // keys per staged tile
constexpr float kMInit = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Shape {
  int B, S, T, H, G, D, causal, window;
  float scale;
};

template <int DP>
struct Layout {
  static constexpr int kTPR = DP >= 32 ? DP / 32 : 1;  // lanes per row
  static constexpr int kDT = DP / kTPR;                // dims per lane
  static constexpr int kNCH = kDT / 4;                 // float4 chunks
  static constexpr int kThreads = kBQ * kTPR;
};

template <typename Tin, int DP>
__global__ void __launch_bounds__(Layout<DP>::kThreads, 2)
    flash_attention_kernel(const Tin* __restrict__ q,
                           const Tin* __restrict__ k,
                           const Tin* __restrict__ v, Tin* __restrict__ o,
                           Shape sh) {
  using L = Layout<DP>;
  constexpr int TPR = L::kTPR, DT = L::kDT, NCH = L::kNCH;
  __shared__ __align__(16) float ks[kBK][DP];
  __shared__ __align__(16) float vs[kBK][DP];

  const int tid = threadIdx.x;
  const int row = tid / TPR, part = tid % TPR;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (sh.H / sh.G);
  const int qpos = q0 + row;
  const bool live = qpos < sh.S;
  const float neg_inf = __int_as_float(0xff800000);

  float qr[DT], acc[DT];
  const Tin* qrow =
      q + (((size_t)b * sh.S + (live ? qpos : 0)) * sh.H + h) * sh.D;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c = part + TPR * i;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * c + e;
      qr[4 * i + e] = (live && d < sh.D) ? to_f32(qrow[d]) : 0.f;
      acc[4 * i + e] = 0.f;
    }
  }
  float m = kMInit, l = 0.f;

  // the keys any row of this tile keeps, rounded out to whole tiles
  int k_begin = 0, k_end = sh.T;
  if (sh.causal) k_end = min(sh.T, min(q0 + kBQ, sh.S));
  if (sh.window) k_begin = max(0, q0 - sh.window + 1) / kBK * kBK;

  const size_t kv_row = (size_t)sh.G * sh.D;
  const Tin* kb = k + (size_t)b * sh.T * kv_row + (size_t)g * sh.D;
  const Tin* vb = v + (size_t)b * sh.T * kv_row + (size_t)g * sh.D;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();
    for (int idx = tid; idx < kBK * DP; idx += L::kThreads) {
      const int j = idx / DP, d = idx % DP;
      const int kp = k0 + j;
      const bool ok = kp < sh.T && d < sh.D;
      ks[j][d] = ok ? to_f32(kb[kp * kv_row + d]) : 0.f;
      vs[j][d] = ok ? to_f32(vb[kp * kv_row + d]) : 0.f;
    }
    __syncthreads();

    float s[kBK];
#pragma unroll
    for (int j = 0; j < kBK; ++j) s[j] = 0.f;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int c = part + TPR * i;
#pragma unroll
      for (int j = 0; j < kBK; ++j) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][4 * c]);
        s[j] = fmaf(qr[4 * i], kk.x, s[j]);
        s[j] = fmaf(qr[4 * i + 1], kk.y, s[j]);
        s[j] = fmaf(qr[4 * i + 2], kk.z, s[j]);
        s[j] = fmaf(qr[4 * i + 3], kk.w, s[j]);
      }
    }
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1)
        s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
      const int kp = k0 + j;
      const bool keep = kp < sh.T && (!sh.causal || qpos >= kp) &&
                        (!sh.window || qpos - kp < sh.window);
      s[j] = keep ? s[j] * sh.scale : neg_inf;
      m_new = fmaxf(m_new, s[j]);
    }
    const float alpha = expf(m - m_new);
    m = m_new;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < DT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const int c = part + TPR * i;
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][4 * c]);
        acc[4 * i] = fmaf(s[j], vv.x, acc[4 * i]);
        acc[4 * i + 1] = fmaf(s[j], vv.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(s[j], vv.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(s[j], vv.w, acc[4 * i + 3]);
      }
    }
  }

  if (!live) return;
  const float denom = fmaxf(l, 1e-30f);
  Tin* orow = o + (((size_t)b * sh.S + qpos) * sh.H + h) * sh.D;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c = part + TPR * i;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * c + e;
      if (d < sh.D) store(orow + d, acc[4 * i + e] / denom);
    }
  }
}

template <typename Tin, int DP>
int launch(const void* q, const void* k, const void* v, void* o, Shape sh,
           cudaStream_t st) {
  const dim3 grid((sh.S + kBQ - 1) / kBQ, sh.H, sh.B);
  flash_attention_kernel<Tin, DP><<<grid, Layout<DP>::kThreads, 0, st>>>(
      static_cast<const Tin*>(q), static_cast<const Tin*>(k),
      static_cast<const Tin*>(v), static_cast<Tin*>(o), sh);
  return static_cast<int>(cudaGetLastError());
}

// D rounded up to the next compiled width: 8, 16, 32, 64 or 128.
template <typename Tin>
int dispatch(const void* q, const void* k, const void* v, void* o,
             Shape sh, cudaStream_t st) {
  if (sh.D <= 8) return launch<Tin, 8>(q, k, v, o, sh, st);
  if (sh.D <= 16) return launch<Tin, 16>(q, k, v, o, sh, st);
  if (sh.D <= 32) return launch<Tin, 32>(q, k, v, o, sh, st);
  if (sh.D <= 64) return launch<Tin, 64>(q, k, v, o, sh, st);
  if (sh.D <= 128) return launch<Tin, 128>(q, k, v, o, sh, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int T, int H, int G, int D, int causal,
                                      int window, int is_bf16,
                                      void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (G <= 0 || H % G != 0 || D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{B, S, T, H, G, D, causal, window,
                 static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)))};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, sh, st)
                 : dispatch<float>(q, k, v, o, sh, st);
}
