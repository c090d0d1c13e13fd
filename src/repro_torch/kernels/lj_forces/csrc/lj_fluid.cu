// Lennard-Jones fluid of a replica stack, written for Hopper (sm_90a): the
// total energy per replica and the forces, uniform sigma and eps, every
// pair under the minimum-image periodic box.
//
// Replaces: src/repro/kernels/lj_forces/kernel.py
//   lj_energy_kernel_batched (pl.pallas_call at :104, body
//   _energy_kernel_batched at :59) and lj_forces_kernel_batched
//   (pl.pallas_call at :126, body _forces_kernel_batched at :74), both
//   through the tile _pair_blocks at :32.
//
// What bounds them on an H100: operations.  At R = 64, N = 864 the
// function needs each of 2.4e7 unordered pairs once; the bytes are
// positions in and forces out, 1.3 MB.
//
// The energy kernel: one block per (i-block of 128 atoms, replica); each
// thread owns one atom i and walks the j-tiles in ascending order, the
// tile's x, y, z staged in shared memory, its energy sum in a register.
// It visits all ordered pairs, as the TPU body does, with the minimum
// image d - box * rint(d / box) (rintf rounds half to even as jnp.round
// does; the division IEEE) and IEEE divisions for sigma^2 / r^2.  The
// diagonal gets r2 += 1 - m with m = 0, as _pair_blocks masks it, so it
// stays finite and contributes exactly zero.  Each block reduces its
// threads' sums in md::block_sum's fixed tree order into an (R, n_blocks)
// scratch, a second kernel sums the blocks in order and halves.
//
// The forces kernel visits each unordered pair once, through the tile-pair
// walk of ../../csrc/pair_tiles.cuh (shared with nonbonded.cu): 64-atom
// tile pairs on a round-robin schedule, Newton's third law with the j-side
// sums handed down the warp by shuffles, three force sums per atom, no
// float atomics; each replica's rounds split over S blocks (lj_forces/
// ops.py block_split, two waves: S = 14 at R = 64, N = 864, one round
// per block, 896 blocks of 7 warps, four resident per SM), each into its
// own partial rows in device memory (3 x ld floats per block, 9.6 MB at
// R = 64, N = 864, held by the L2; rows in shared memory timed no faster
// on an H100, and device rows put no ceiling on N), which a second launch
// adds in block order and scales by 24 eps.  Per pair no division:
//   * the minimum image by one reciprocal, d - box * rint(d * inv_box),
//     inv_box the float32 reciprocal formed once on the host, rint half to
//     even as two float adds of 1.5 * 2^23 (exact for |x| < 2^22; the
//     FRND instruction issues at a quarter of the FMA rate).  It differs
//     from d / box only where d / box is within an ulp of +-1/2 but not on
//     it: a pair near half the box, where the force is small.  The image
//     is odd in d, so F_ij = -F_ji;
//   * inv_r2 = rcp(r2) (one MUFU instruction), tt = sigma^2 inv_r2,
//     s6 = tt^3, c = s6 (2 s6 - 1) inv_r2.
// Only the diagonal tiles and the ragged last tile take a guard: a pair
// with an atom past N gets r2 += 1 - m, c times m (m = 0), so it adds
// exactly zero.  The constants sigma^2, 4 eps, 24 eps and box arrive as
// the float32 values JAX forms (lj_forces/ref.py::fluid_constants).
#include <cuda_runtime.h>

#include "md_terms.cuh"
#include "pair_tiles.cuh"

namespace {

using md::kTile;
using pt::kPT;
using pt::Sums;

// jnp.round(d / box) is half to even: rintf.
__device__ __forceinline__ float min_image(float d, float box) {
  return box > 0.f ? d - box * rintf(d / box) : d;
}

__global__ void __launch_bounds__(kTile) lj_energy_kernel(
    const float* __restrict__ pos, float* __restrict__ out, int N, float box,
    float sig2, float c4) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile];
  __shared__ float red[kTile];
  const int r = blockIdx.y, tid = threadIdx.x;
  const int i = blockIdx.x * kTile + tid;
  const bool live = i < N;
  const float* P = pos + (size_t)r * N * 3;
  md::V3 pi = {0.f, 0.f, 0.f};
  if (live) pi = md::load3(P, i);
  float e = 0.f;
  for (int j0 = 0; j0 < N; j0 += kTile) {
    const int j = j0 + tid;
    __syncthreads();
    if (j < N) {
      sx[tid] = P[3 * j];
      sy[tid] = P[3 * j + 1];
      sz[tid] = P[3 * j + 2];
    }
    __syncthreads();
    const int nj = min(kTile, N - j0);
    if (!live) continue;
    for (int jj = 0; jj < nj; ++jj) {
      const float m = (j0 + jj == i) ? 0.f : 1.f;
      const float dx = min_image(pi.x - sx[jj], box);
      const float dy = min_image(pi.y - sy[jj], box);
      const float dz = min_image(pi.z - sz[jj], box);
      const float r2 = dx * dx + dy * dy + dz * dz + (1.f - m);
      const float t = sig2 / r2;
      const float s6 = t * (t * t);
      e += c4 * (s6 * s6 - s6) * m;
    }
  }
  const float b = md::block_sum(e, red);
  if (tid == 0) out[(size_t)r * gridDim.x + blockIdx.x] = b;
}

// energy[r] = 0.5 * the in-order sum of replica r's block sums.
__global__ void block_energy_kernel(const float* __restrict__ e_part,
                                    float* __restrict__ energy, int R,
                                    int n_blocks) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float* ep = e_part + (size_t)r * n_blocks;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += ep[b];
  energy[r] = 0.5f * s;
}

// rint(x), half to even, for |x| < 2^22: the sum with 1.5 * 2^23 rounds x
// to an integer in the default rounding mode; __fadd_rn / __fsub_rn are
// never contracted or reassociated.
__device__ __forceinline__ float rint_small(float x) {
  return __fsub_rn(__fadd_rn(x, 12582912.0f), 12582912.0f);
}

constexpr int kStageBytes = 16;   // a staged j atom: float4 (x, y, z, -)

struct FluidPair {
  static constexpr int kRows = 3;
  // unroll of the walk: the fastest of 1, 2, 3, 4, 8 and 16 at R = 64,
  // N = 864 on an H100 80GB HBM3 (700 W), every one bitwise the same sums
  static constexpr int kUnroll = 8;
  struct Atom {
    float x, y, z;
  };
  using JAtom = float4;

  const float* P;      // this replica's (N, 3) positions
  float4* jx;          // this warp's staged j atoms
  float* rows;         // the block's (3, ld) partial force rows (device)
  int ld, N;
  float box, inv_box, sig2;

  __device__ __forceinline__ Atom load_i(int i) const {
    if (i >= N) return {0.f, 0.f, 0.f};
    return {P[3 * i], P[3 * i + 1], P[3 * i + 2]};
  }

  __device__ __forceinline__ void stage(int t, int lane) const {
    __syncwarp();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int jl = lane + 32 * u, j = kPT * t + jl;
      jx[jl] = j < N ? make_float4(P[3 * j], P[3 * j + 1], P[3 * j + 2], 0.f)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncwarp();
  }

  __device__ __forceinline__ JAtom load_j(int jj) const { return jx[jj]; }

  // Bit b: atom i and atom 64 J + 32 h + b are both real.
  __device__ __forceinline__ uint32_t word(int i, int J, int h) const {
    const int n = N - (kPT * J + 32 * h);
    if (i >= N || n <= 0) return 0u;
    return n >= 32 ? 0xffffffffu : (1u << n) - 1u;
  }

  // I < J: both tiles hold only real atoms.
  __device__ __forceinline__ bool kept(int, int J) const {
    return kPT * (J + 1) <= N;
  }

  __device__ __forceinline__ float image(float d) const {
    return d - box * rint_small(d * inv_box);
  }

  template <bool kMasked>
  __device__ __forceinline__ void pair(const Atom& a, const JAtom& j,
                                       float m, Sums<kRows>& fi,
                                       Sums<kRows>& fj) const {
    const float dx = image(a.x - j.x), dy = image(a.y - j.y),
                dz = image(a.z - j.z);
    float r2 = dx * dx + dy * dy + dz * dz;
    if (kMasked) r2 += 1.0f - m;
    const float inv_r2 = pt::rcp_approx(r2);
    const float tt = sig2 * inv_r2;
    const float s6 = tt * (tt * tt);
    float c = s6 * (2.0f * s6 - 1.0f) * inv_r2;
    if (kMasked) c *= m;
    fi.v[0] += c * dx;
    fi.v[1] += c * dy;
    fi.v[2] += c * dz;
    fj.v[0] -= c * dx;
    fj.v[1] -= c * dy;
    fj.v[2] -= c * dz;
  }

  __device__ __forceinline__ void flush() const {}
};

// Block s of replica r: its rounds of the schedule into its partial rows
// part[r, s] (3, ld).
__global__ void __launch_bounds__(32 * pt::kMaxWarps)
    lj_forces_pairs_kernel(const float* __restrict__ pos,
                           const int* __restrict__ sched,
                           float* __restrict__ part, int N, int ld, int S,
                           float box, float inv_box, float sig2) {
  constexpr int kRows = FluidPair::kRows;
  extern __shared__ float4 smem4[];
  const int s = blockIdx.x, r = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  FluidPair p;
  p.P = pos + (size_t)r * N * 3;
  p.jx = smem4 + warp * kPT;
  p.rows = part + ((size_t)r * S + s) * kRows * ld;
  p.ld = ld;
  p.N = N;
  p.box = box;
  p.inv_box = inv_box;
  p.sig2 = sig2;

  pt::zero_rows(p.rows, kRows * ld);
  __syncthreads();
  pt::walk_rounds(p, sched, ld / kPT, s, S, lane);
}

// forces = 24 eps x the S partials of each replica added in block order.
__global__ void lj_forces_combine_kernel(const float* __restrict__ part,
                                         float* __restrict__ forces, int N,
                                         int ld, int S, float c24) {
  constexpr int kRows = FluidPair::kRows;
  const int r = blockIdx.y, i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  float acc[kRows] = {0.f, 0.f, 0.f};
  for (int s = 0; s < S; ++s) {
    const float* src = part + ((size_t)r * S + s) * kRows * ld + i;
#pragma unroll
    for (int k = 0; k < kRows; ++k) acc[k] += src[(size_t)k * ld];
  }
  float* F = forces + ((size_t)r * N + i) * 3;
#pragma unroll
  for (int k = 0; k < kRows; ++k) F[k] = c24 * acc[k];
}

}  // namespace

extern "C" int lj_energy_launch(const float* pos, float* e_part,
                                float* energy, int R, int N, float box,
                                float sig2, float c4, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_blocks = (N + kTile - 1) / kTile;
  lj_energy_kernel<<<dim3(n_blocks, R), kTile, 0, st>>>(pos, e_part, N, box,
                                                        sig2, c4);
  block_energy_kernel<<<(R + 127) / 128, 128, 0, st>>>(e_part, energy, R,
                                                       n_blocks);
  return static_cast<int>(cudaGetLastError());
}

// sched: the (ld / 64, ld / 64) round table; part: (R, S, 3, ld) scratch;
// inv_box: the float32 1 / box (0 for no box).
extern "C" int lj_forces_launch(const float* pos, const int* sched,
                                float* part, float* forces, int R, int N,
                                int ld, int S, float box, float inv_box,
                                float sig2, float c24, void* stream) {
  if (R == 0 || N == 0) return 0;
  const int n_t = ld / kPT;
  if (ld % (2 * kPT) != 0 || ld < N || S < 1 || S > n_t)
    return static_cast<int>(cudaErrorInvalidValue);
  // the staged j atoms alone: at most 24 warps x 1 KB, under the 48 KB
  // that needs no opt-in
  const int smem = pt::pair_warps(n_t) * kPT * kStageBytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  lj_forces_pairs_kernel<<<dim3(S, R), 32 * pt::pair_warps(n_t), smem,
                           st>>>(pos, sched, part, N, ld, S, box, inv_box,
                                 sig2);
  lj_forces_combine_kernel<<<dim3((N + 127) / 128, R), 128, 0, st>>>(
      part, forces, N, ld, S, c24);
  return static_cast<int>(cudaGetLastError());
}
