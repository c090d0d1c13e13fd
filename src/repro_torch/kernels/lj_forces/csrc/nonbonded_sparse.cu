// Neighbor-list chain nonbonded pass for a replica stack, written for Hopper
// (sm_90a): Lennard-Jones (Lorentz-Berthelot mixing from per-atom sigma and
// sqrt(eps)) plus bare Coulomb over each atom's K list slots, every slot
// masked by its validity and by the true cutoff; LJ and electrostatic force
// rows written separately, plus both energies.
//
// Replaces: src/repro/kernels/lj_forces/kernel.py
//   nonbonded_sparse_kernel_batched (pl.pallas_call at :268, body
//   _nonbonded_sparse_kernel_batched at :205).  The salt scale stays outside
//   the kernel, as in lj_forces/ops.py.
//
// Per slot, the TPU body's arithmetic: mask = valid * [r2 <= cutoff^2],
// r2 += 1 - mask, sigma the Lorentz mean, eps = sqrt(eps_i) * sqrt(eps_j) (the
// kernel's form, not the PyTorch oracle's sqrt(eps_i eps_j)), then the pair
// term md::pair_accumulate shared with the all-pairs kernels; e = 1/2 sum.
// r2 is formed without FMA contraction (__fmul_rn / __fadd_rn), as PyTorch's
// separate elementwise ops form it, so the cutoff mask equals the plain
// version's bit for bit and a pair at the cutoff cannot flip.
//
// Layout: idx (int32) and valid (f32) are read in the list's own (R, N, K)
// layout, not the TPU kernel's slot-major (R, Kp, Np).  The list is built
// and kept in (R, N, K) (the JAX package's layout, which the parity tests
// compare); a transpose per call would move the tables twice more than the
// kernel itself reads them.  Each thread reads its own K contiguous slots;
// a warp's reads of one slot are K * 4 bytes apart, and the 128-byte lines
// they touch are reused by the next slots from L1.
//
// Design: one thread per (replica, atom i), blocks of 128 atoms of one
// replica.  The thread reads its K indices and gathers each neighbor's
// position and atom rows by indexed loads: the replica's positions (35 KB at
// N = 2881) and the atom rows stay in L1/L2, unlike the TPU kernel's one-hot
// (Np, Np) gather matmul per slot.  Padding slots hold N and are clipped to
// atom N - 1; their validity 0 masks them.  Energies: each block reduces its
// threads' sums in a fixed tree order into an (R, n_tiles, 2) scratch and
// md::tile_energy_kernel sums the tiles in order.  No float atomics, so
// run_fused stays bitwise invariant to the chunk size.
//
// What bounds it on an H100: bytes.  At R = 384, N = 2881, K = 15 the idx and
// valid tables are 133 MB, against a few hundred million pair operations.
#include <cuda_runtime.h>
#include <stdint.h>

#include "md_terms.cuh"

namespace {

using md::kTile;

__global__ void __launch_bounds__(kTile) nonbonded_sparse_kernel(
    const float* __restrict__ pos, const float* __restrict__ sigma,
    const float* __restrict__ sqrt_eps, const float* __restrict__ charge,
    const int* __restrict__ idx, const float* __restrict__ valid,
    float* __restrict__ f_lj, float* __restrict__ f_el,
    float* __restrict__ e_part, int N, int K, float cutoff2, float coulomb) {
  __shared__ float red[kTile];
  const int r = blockIdx.y, tid = threadIdx.x;
  const int i = blockIdx.x * kTile + tid;
  md::PairAcc acc;
  if (i < N) {
    const float* P = pos + (size_t)r * N * 3;
    const md::V3 pi = md::load3(P, i);
    const float si = sigma[i], ei = sqrt_eps[i], qi = charge[i];
    const size_t row = ((size_t)r * N + i) * K;
    const int* I = idx + row;
    const float* V = valid + row;
    for (int k = 0; k < K; ++k) {
      const int j = min(max(I[k], 0), N - 1);
      const md::V3 pj = md::load3(P, j);
      const float dx = pi.x - pj.x, dy = pi.y - pj.y, dz = pi.z - pj.z;
      const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                           __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      const float m = V[k] * (r2 <= cutoff2 ? 1.0f : 0.0f);
      md::pair_accumulate<true>(dx, dy, dz, r2 + (1.0f - m), m,
                                0.5f * (si + sigma[j]), ei * sqrt_eps[j],
                                qi * charge[j], coulomb, acc);
    }
    float* FL = f_lj + ((size_t)r * N + i) * 3;
    float* FE = f_el + ((size_t)r * N + i) * 3;
    FL[0] = acc.flx;
    FL[1] = acc.fly;
    FL[2] = acc.flz;
    FE[0] = acc.fex;
    FE[1] = acc.fey;
    FE[2] = acc.fez;
  }
  const float blj = md::block_sum(acc.e_lj, red);
  const float bel = md::block_sum(acc.e_el, red);
  if (tid == 0) {
    float* ep = e_part + ((size_t)r * gridDim.x + blockIdx.x) * 2;
    ep[0] = blj;
    ep[1] = bel;
  }
}

}  // namespace

extern "C" int nonbonded_sparse_launch(
    const float* pos, const float* sigma, const float* sqrt_eps,
    const float* charge, const int* idx, const float* valid, float* f_lj,
    float* f_el, float* e_part, float* e_lj, float* e_el, int R, int N, int K,
    float cutoff2, float coulomb, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (N + kTile - 1) / kTile;
  nonbonded_sparse_kernel<<<dim3(n_tiles, R), kTile, 0, st>>>(
      pos, sigma, sqrt_eps, charge, idx, valid, f_lj, f_el, e_part, N, K,
      cutoff2, coulomb);
  md::tile_energy_kernel<<<(R + 127) / 128, 128, 0, st>>>(e_part, e_lj,
                                                          e_el, R, n_tiles);
  return static_cast<int>(cudaGetLastError());
}
