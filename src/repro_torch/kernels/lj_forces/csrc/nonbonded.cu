// All-pairs chain nonbonded pass for a replica stack, written for Hopper
// (sm_90a): Lennard-Jones (Lorentz-Berthelot mixing from per-atom sigma
// and sqrt(eps)) plus bare Coulomb, with a 0/1 exclusion mask; LJ and
// electrostatic forces written separately, plus both energies.
//
// Replaces: src/repro/kernels/lj_forces/kernel.py
//   nonbonded_kernel_batched (pl.pallas_call at :295, body
//   _nonbonded_kernel_batched at :181).  The salt scale stays outside the
//   kernel, as in lj_forces/ops.py.
//
// What bounds it on an H100: operations.  The function needs each kept
// unordered pair once (4.1e6 per replica at N = 2881, 2.6e8 at R = 64),
// about 52 flops each; the bytes are small (positions in, two force
// stacks out, 9 KB of atom rows, the pack's 1.1 MB of mask bits).
//
// Design (the pair walk is ../../csrc/pair_tiles.cuh, shared with
// lj_fluid.cu's forces kernel):
//   * Each unordered pair once, Newton's third law: a round-robin schedule
//     of 64-atom tile pairs, the j-side sums handed down the warp by
//     shuffles, no float atomics.  Six force sums per atom (LJ and Coulomb
//     apart) and two energy sums per lane; each pair enters each energy
//     once, so nothing is halved.
//   * Per pair one reciprocal square root and products, no division:
//     rinv = rsqrt(r2), inv_r2 = rinv^2, tt = sigma^2 inv_r2, s6 = tt^3,
//     u = s6^2 - s6; e_lj += eps u, e_el += qq rinv, c_lj = eps (u + s6^2)
//     inv_r2, c_el = qq rinv inv_r2, with sigma / 2, sqrt(eps) and q per
//     atom.  The constant factors (24 and 4 for LJ, COULOMB for both
//     Coulomb sums) multiply the finished sums once, in the combine launch.
//   * The mask comes as the pack's 32-bit rows of mask bits and a flag per
//     64 x 64 tile pair that holds only kept pairs of real atoms
//     (lj_forces/ops.py tile_flags): such a tile pair (946 of the 1,035 off
//     the diagonal on the 2881-atom chain) runs with no mask; elsewhere a
//     lane reads one word of bits per i-atom and half tile, and a masked or
//     padding pair gets r2 += 1 - m and eps, qq times m, so it stays finite
//     and adds exactly zero.
//   * Split: at R = 64 one block per replica would fill 64 of the 132 SMs.
//     So block_split (lj_forces/ops.py) gives each replica S blocks, S =
//     132 x 24 warps / (R x warps per block), at least 1, at most n_t: a
//     wave of one block per SM at 24 warps each, a function of R and N
//     only.  R = 64, N = 2881: 23 warps per block, S = 2, 128 blocks.  Each
//     block sums its rounds into its own partial rows (6 x ld floats, in
//     shared memory up to ld = 8064, in device memory above: no ceiling on
//     N) and its energy sums in a fixed-order block reduction; the combine
//     launch adds the S partials in block order and scales them.  The
//     split is fixed for a shape, so results are bitwise repeatable and
//     run_fused stays chunk-size invariant.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_tiles.cuh"

namespace {

using pt::kPT;
using pt::Sums;

constexpr int kStageBytes = 24; // a staged j atom: float4 + float2

struct NbPair {
  static constexpr int kRows = 6;   // LJ x, y, z, Coulomb x, y, z
  // unroll of the walk: the fastest of 1, 2, 3, 4, 8 and 16 at R = 64,
  // N = 2881 on an H100 80GB HBM3 (700 W), every one bitwise the same sums
  static constexpr int kUnroll = 2;
  // Per-atom constants: position, sigma / 2, sqrt(eps), q.
  struct Atom {
    float x, y, z, hs, se, q;
  };
  struct JAtom {
    float4 xq;   // x, y, z, q
    float2 se;   // sigma / 2, sqrt(eps)
  };

  const float* P;          // this replica's (N, 3) positions
  const float* sigma;
  const float* sqrt_eps;
  const float* charge;
  const uint32_t* bits;    // (ld, ld / 32) mask bits
  const uint8_t* kept_t;   // (n_t, n_t) all-kept flags
  float4* jxq;             // this warp's staged j atoms
  float2* jse;
  float* rows;             // the block's (6, ld) partial force rows
  int ld, N, nw, n_t;
  float e_lj = 0.f, e_el = 0.f;      // this lane's sums, current entry
  float t_lj = 0.f, t_el = 0.f;      // and over its entries

  __device__ __forceinline__ Atom load_i(int i) const {
    if (i >= N) return {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    return {P[3 * i], P[3 * i + 1], P[3 * i + 2], 0.5f * sigma[i],
            sqrt_eps[i], charge[i]};
  }

  // Tile t's atoms into this warp's buffers (zeros past N).
  __device__ __forceinline__ void stage(int t, int lane) const {
    __syncwarp();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int jl = lane + 32 * u, j = kPT * t + jl;
      if (j < N) {
        jxq[jl] = make_float4(P[3 * j], P[3 * j + 1], P[3 * j + 2],
                              charge[j]);
        jse[jl] = make_float2(0.5f * sigma[j], sqrt_eps[j]);
      } else {
        jxq[jl] = make_float4(0.f, 0.f, 0.f, 0.f);
        jse[jl] = make_float2(0.f, 0.f);
      }
    }
    __syncwarp();
  }

  __device__ __forceinline__ JAtom load_j(int jj) const {
    return {jxq[jj], jse[jj]};
  }

  __device__ __forceinline__ uint32_t word(int i, int J, int h) const {
    return bits[(size_t)i * nw + 2 * J + h];
  }

  __device__ __forceinline__ bool kept(int I, int J) const {
    return kept_t[I * n_t + J] != 0;
  }

  template <bool kMasked>
  __device__ __forceinline__ void pair(const Atom& a, const JAtom& j,
                                       float m, Sums<kRows>& fi,
                                       Sums<kRows>& fj) {
    const float dx = a.x - j.xq.x, dy = a.y - j.xq.y, dz = a.z - j.xq.z;
    float r2 = dx * dx + dy * dy + dz * dz;
    float ee = a.se * j.se.y, qq = a.q * j.xq.w;
    if (kMasked) {
      r2 += 1.0f - m;
      ee *= m;
      qq *= m;
    }
    const float rinv = pt::rsqrt_approx(r2);
    const float inv_r2 = rinv * rinv;
    const float sig = a.hs + j.se.x;
    const float tt = sig * sig * inv_r2;
    const float s6 = tt * (tt * tt);
    const float u = s6 * s6 - s6;
    const float qr = qq * rinv;
    e_lj += ee * u;
    e_el += qr;
    const float clj = ee * (u + s6 * s6) * inv_r2;
    const float cel = qr * inv_r2;
    fi.v[0] += clj * dx;
    fi.v[1] += clj * dy;
    fi.v[2] += clj * dz;
    fi.v[3] += cel * dx;
    fi.v[4] += cel * dy;
    fi.v[5] += cel * dz;
    fj.v[0] -= clj * dx;
    fj.v[1] -= clj * dy;
    fj.v[2] -= clj * dz;
    fj.v[3] -= cel * dx;
    fj.v[4] -= cel * dy;
    fj.v[5] -= cel * dz;
  }

  __device__ __forceinline__ void flush() {
    t_lj += e_lj;
    t_el += e_el;
    e_lj = e_el = 0.f;
  }
};

// Sum over the warp in a fixed butterfly order (every lane gets it).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block s of replica r: its rounds of the schedule into its partial rows
// part[r, s] (6, ld) and its energy sums e_part[r, s] (2).
__global__ void __launch_bounds__(32 * pt::kMaxWarps, 1)
    nonbonded_pairs_kernel(const float* __restrict__ pos,
                           const float* __restrict__ sigma,
                           const float* __restrict__ sqrt_eps,
                           const float* __restrict__ charge,
                           const uint32_t* __restrict__ bits,
                           const uint8_t* __restrict__ kept,
                           const int* __restrict__ sched,
                           float* __restrict__ part,
                           float* __restrict__ e_part, int N, int ld, int S,
                           int rows_in_smem) {
  constexpr int kRows = NbPair::kRows;
  extern __shared__ float4 smem4[];
  const int s = blockIdx.x, r = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  float2* jse0 = reinterpret_cast<float2*>(smem4 + n_warps * kPT);
  float* srows = reinterpret_cast<float*>(jse0 + n_warps * kPT);
  float* grows = part + ((size_t)r * S + s) * kRows * ld;

  NbPair p;
  p.P = pos + (size_t)r * N * 3;
  p.sigma = sigma;
  p.sqrt_eps = sqrt_eps;
  p.charge = charge;
  p.bits = bits;
  p.kept_t = kept;
  p.jxq = smem4 + warp * kPT;
  p.jse = jse0 + warp * kPT;
  p.rows = rows_in_smem ? srows : grows;
  p.ld = ld;
  p.N = N;
  p.nw = ld / 32;
  p.n_t = ld / kPT;

  pt::zero_rows(p.rows, kRows * ld);
  __syncthreads();
  pt::walk_rounds(p, sched, p.n_t, s, S, lane);
  if (rows_in_smem) pt::copy_rows(grows, srows, kRows * ld);

  // the staging buffers are free after the last round's barrier
  float* red = reinterpret_cast<float*>(smem4);
  const float lj = warp_sum(p.t_lj), el = warp_sum(p.t_el);
  if (lane == 0) {
    red[2 * warp] = lj;
    red[2 * warp + 1] = el;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < n_warps; ++w) {
      a += red[2 * w];
      b += red[2 * w + 1];
    }
    e_part[((size_t)r * S + s) * 2] = a;
    e_part[((size_t)r * S + s) * 2 + 1] = b;
  }
}

// The S partials of each replica added in block order, then scaled:
// f_lj = 24 sum, f_el = COULOMB sum, e_lj = 4 sum, e_el = COULOMB sum.
__global__ void nonbonded_combine_kernel(const float* __restrict__ part,
                                         const float* __restrict__ e_part,
                                         float* __restrict__ f_lj,
                                         float* __restrict__ f_el,
                                         float* __restrict__ e_lj,
                                         float* __restrict__ e_el, int N,
                                         int ld, int S, float coulomb) {
  constexpr int kRows = NbPair::kRows;
  const int r = blockIdx.y, i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < N) {
    float acc[kRows] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < S; ++s) {
      const float* src = part + ((size_t)r * S + s) * kRows * ld + i;
#pragma unroll
      for (int k = 0; k < kRows; ++k) acc[k] += src[(size_t)k * ld];
    }
    float* FL = f_lj + ((size_t)r * N + i) * 3;
    float* FE = f_el + ((size_t)r * N + i) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      FL[c] = 24.0f * acc[c];
      FE[c] = coulomb * acc[3 + c];
    }
  }
  if (i == 0) {
    float a = 0.f, b = 0.f;
    for (int s = 0; s < S; ++s) {
      a += e_part[((size_t)r * S + s) * 2];
      b += e_part[((size_t)r * S + s) * 2 + 1];
    }
    e_lj[r] = 4.0f * a;
    e_el[r] = coulomb * b;
  }
}

}  // namespace

// sched: the (ld / 64, ld / 64) round table; part: (R, S, 6, ld) scratch;
// e_part: (R, S, 2) scratch; rows_in_smem: 1 to keep the partial rows in
// shared memory (they must fit), 0 to keep them in part.
extern "C" int nonbonded_launch(const float* pos, const float* sigma,
                                const float* sqrt_eps, const float* charge,
                                const uint32_t* bits, const uint8_t* kept,
                                const int* sched, float* part,
                                float* e_part, float* f_lj, float* f_el,
                                float* e_lj, float* e_el, int R, int N,
                                int ld, int S, int rows_in_smem,
                                float coulomb, void* stream) {
  constexpr int kRows = NbPair::kRows;
  if (R == 0 || N == 0) return 0;
  const int n_t = ld / kPT;
  const int smem = pt::smem_bytes(n_t, kStageBytes,
                                  rows_in_smem ? kRows * ld : 0);
  if (ld % (2 * kPT) != 0 || ld < N || smem == 0 || S < 1 || S > n_t)
    return static_cast<int>(cudaErrorInvalidValue);
  // The shared-memory opt-in holds for the current device only: set it on
  // a device's first call, before any graph capture on it.
  constexpr int kMaxDevices = 64;
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !attr_set[dev]) {
    err = cudaFuncSetAttribute(nonbonded_pairs_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               pt::kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) attr_set[dev] = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  nonbonded_pairs_kernel<<<dim3(S, R), 32 * pt::pair_warps(n_t), smem,
                           st>>>(pos, sigma, sqrt_eps, charge, bits, kept,
                                 sched, part, e_part, N, ld, S,
                                 rows_in_smem);
  nonbonded_combine_kernel<<<dim3((N + 127) / 128, R), 128, 0, st>>>(
      part, e_part, f_lj, f_el, e_lj, e_el, N, ld, S, coulomb);
  return static_cast<int>(cudaGetLastError());
}
