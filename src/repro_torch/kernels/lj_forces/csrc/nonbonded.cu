// All-pairs chain nonbonded pass for a replica stack, written for Hopper
// (sm_90a): Lennard-Jones (Lorentz-Berthelot mixing from per-atom sigma
// and sqrt(eps)) plus bare Coulomb, with a 0/1 exclusion mask; LJ and
// electrostatic forces written separately, plus both energies.
//
// Replaces: src/repro/kernels/lj_forces/kernel.py
//   nonbonded_kernel_batched (pl.pallas_call at :295, body
//   nonbonded_pair_rows at :149).  The salt scale stays outside the kernel,
//   as in lj_forces/ops.py.
//
// What bounds it on an H100: operations.  Every replica evaluates all N^2
// ordered pairs (5.3e8 at R = 64, N = 2881) at 52 flops each as counted from
// nonbonded_pair_rows, four of them IEEE divisions and one a square root;
// the bytes are small (positions, 9 KB of atom rows, the 8.7 MB uint8 mask
// that every replica re-reads from L2).
//
// Design: one block per (i-tile of 128 atoms, replica); each thread owns one
// atom i and keeps its six force sums and two energy sums in registers.  The
// block walks the j-tiles: the per-atom rows (x, y, z, sigma, sqrt_eps, q)
// of a tile are staged in shared memory, the thread reads its own 128-byte
// slice of mask row i as eight 16-byte loads.  Masked pairs get
// r2 += 1 - mask exactly as at lj_forces/kernel.py:162, so they stay finite
// and contribute exactly zero.  Energies: each block reduces its threads'
// sums in a fixed tree order into an (R, n_tiles, 2) scratch, and a second
// kernel sums the tiles in order.  No atomics: bitwise reproducible.
// Speed work (reciprocals instead of divisions, wider j reuse, symmetry)
// is for later; this version keeps the TPU kernel's arithmetic.  The sweep
// itself (md::nb_sweep) lives in ../../csrc/md_terms.cuh, shared with
// fused_baoab.cu.
#include <cuda_runtime.h>
#include <stdint.h>

#include "md_terms.cuh"

namespace {

using md::kTile;

__device__ __forceinline__ float block_sum(float v, float* sh) {
  const int tid = threadIdx.x;
  sh[tid] = v;
  __syncthreads();
  for (int s = kTile / 2; s > 0; s >>= 1) {
    if (tid < s) sh[tid] += sh[tid + s];
    __syncthreads();
  }
  const float out = sh[0];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kTile) nonbonded_tile_kernel(
    const float* __restrict__ pos, const float* __restrict__ sigma,
    const float* __restrict__ sqrt_eps, const float* __restrict__ charge,
    const uint8_t* __restrict__ mask, float* __restrict__ f_lj,
    float* __restrict__ f_el, float* __restrict__ e_part, int N, int ld,
    float coulomb) {
  __shared__ md::NbTile tile;
  __shared__ float red[kTile];
  const int r = blockIdx.y, tid = threadIdx.x;
  const int i = blockIdx.x * kTile + tid;
  const bool live = i < N;
  const float* P = pos + (size_t)r * N * 3;
  md::V3 pi = {0.f, 0.f, 0.f};
  float si = 0.f, ei = 0.f, qi = 0.f;
  if (live) {
    pi = md::load3(P, i);
    si = sigma[i];
    ei = sqrt_eps[i];
    qi = charge[i];
  }
  md::PairAcc acc;
  md::nb_sweep<true>(P, sigma, sqrt_eps, charge,
                     mask + (size_t)(live ? i : 0) * ld, N, live, pi, si, ei,
                     qi, coulomb, tile, acc);
  if (live) {
    float* FL = f_lj + ((size_t)r * N + i) * 3;
    float* FE = f_el + ((size_t)r * N + i) * 3;
    FL[0] = acc.flx;
    FL[1] = acc.fly;
    FL[2] = acc.flz;
    FE[0] = acc.fex;
    FE[1] = acc.fey;
    FE[2] = acc.fez;
  }
  const float blj = block_sum(acc.e_lj, red);
  const float bel = block_sum(acc.e_el, red);
  if (tid == 0) {
    float* ep = e_part + ((size_t)r * gridDim.x + blockIdx.x) * 2;
    ep[0] = blj;
    ep[1] = bel;
  }
}

// e[r] = 0.5 * sum over tiles in order (one thread per replica).
__global__ void nonbonded_energy_kernel(const float* __restrict__ e_part,
                                        float* __restrict__ e_lj,
                                        float* __restrict__ e_el, int R,
                                        int n_tiles) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float* ep = e_part + (size_t)r * n_tiles * 2;
  float lj = 0.f, el = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    lj += ep[2 * t];
    el += ep[2 * t + 1];
  }
  e_lj[r] = 0.5f * lj;
  e_el[r] = 0.5f * el;
}

}  // namespace

extern "C" int nonbonded_launch(const float* pos, const float* sigma,
                                const float* sqrt_eps, const float* charge,
                                const uint8_t* mask, float* f_lj,
                                float* f_el, float* e_part, float* e_lj,
                                float* e_el, int R, int N, int ld,
                                float coulomb, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = ld / kTile;
  nonbonded_tile_kernel<<<dim3(n_tiles, R), kTile, 0, st>>>(
      pos, sigma, sqrt_eps, charge, mask, f_lj, f_el, e_part, N, ld, coulomb);
  nonbonded_energy_kernel<<<(R + 127) / 128, 128, 0, st>>>(e_part, e_lj, e_el,
                                                           R, n_tiles);
  return static_cast<int>(cudaGetLastError());
}
