// One masked force-sharing BAOAB iteration for a replica stack, in one
// launch, written for Hopper (sm_90a): the bonded force (bonds, angles,
// torsions, optional umbrella torque), the all-pairs nonbonded force
// (LJ + salt-scaled Coulomb, exclusion mask) and the B-A-O-A-B update of
// positions and velocities.
//
// Replaces: src/repro/kernels/fused_propagate/kernel.py
//   fused_baoab_kernel_batched (pl.pallas_call at :98, program
//   _fused_baoab_kernel), both variants (bias=False / bias=True).
//
// What bounds it on an H100: operations.  The nonbonded sweep is O(N^2)
// per replica (each kept pair at about 46 flops for the two force rows,
// 7.4e10 flops at R = 384, N = 2881, 1.1 ms at 67 TFLOP/s fp32); the bonded
// terms and the update are O(N) and the bytes (positions, velocities and
// noise in, positions and velocities out, the 8.7 MB uint8 mask re-read
// from L2) are a few tens of MB.
//
// Design.  The TPU kernel is one program per replica over a full (Np, Np)
// tile, with one-hot MXU matmuls for the bonded gather and scatter.  That
// shape would leave most of the 132 SMs idle at small R and needs the
// 312 MB one-hot matrix.  Here the update is atom-local, so it fuses with an
// i-block of the nonbonded sweep:
//   * grid (i-blocks of 128 atoms, R); each thread owns one atom i.  The
//     block sweeps all j tiles exactly as nonbonded.cu does (md::nb_sweep,
//     shared through ../../csrc/md_terms.cuh, energies compiled out).
//   * Bonded, in the same launch: the thread sums the <= S signed edge
//     slots of its atom (the slot table of chain_forces/ref.bonded_slots,
//     built once at pack time), recomputing each slot's term from the
//     positions with the same device code as chain_forces.cu's phase 1.
//     A term is thus evaluated once per edge slot that touches it (2-4
//     atoms, up to two slots each), about S <= 15 term evaluations per
//     atom against about N = 2881 pair evaluations: a few per cent of the
//     sweep.  In return the iteration is one launch with no edge scratch
//     and no dependence between blocks (the alternative, chain_forces.cu's
//     edge phase first, costs a second launch and an L2 round trip per
//     iteration).
//   * Positions and velocities are double-buffered (read pos/vel, write
//     npos/nvel): other blocks still read pos while this one writes.
//   * The force is summed as f = fb + (lj + salt * el), the order of the
//     plain loop; noise comes in pre-scaled (noise_scale * xi, drawn by
//     md/noise.py); energies are not an output.
// No float atomics: bitwise identical run to run, so run_fused's decisions
// do not depend on the chunk size.
#include <cuda_runtime.h>
#include <stdint.h>

#include "md_terms.cuh"

namespace {

using md::kTile;

template <bool kBias>
__global__ void __launch_bounds__(kTile) fused_baoab_kernel(
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ noise, const float* __restrict__ step_par,
    const float* __restrict__ bias, md::BondedTables tab,
    const int* __restrict__ slot_idx, const float* __restrict__ slot_sign,
    const float* __restrict__ sigma, const float* __restrict__ sqrt_eps,
    const float* __restrict__ charge, const uint8_t* __restrict__ mask,
    const float* __restrict__ masses, float* __restrict__ npos,
    float* __restrict__ nvel, int N, int ld, int W, int S, float coulomb,
    float c1, float half_kick, float half_dt) {
  __shared__ md::NbTile tile;
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
  md::nb_sweep<false>(P, sigma, sqrt_eps, charge,
                      mask + (size_t)(live ? i : 0) * ld, N, live, pi, si,
                      ei, qi, coulomb, tile, acc);
  if (!live) return;

  // bonded: force = -sum_s sign[i, s] * edge[slot_idx[i, s]], slot order
  const float* brow = kBias ? bias + (size_t)r * 8 : nullptr;
  float bx = 0.f, by = 0.f, bz = 0.f;
  for (int s = 0; s < S; ++s) {
    const float sg = slot_sign[i * S + s];
    if (sg == 0.f) continue;                   // padding slot
    const md::V3 e =
        md::edge_of_slot<kBias>(P, tab, slot_idx[i * S + s], W, brow);
    bx += sg * e.x;
    by += sg * e.y;
    bz += sg * e.z;
  }

  const float* st = step_par + (size_t)r * 8;
  const bool trail = st[0] > 0.5f, lead = st[1] > 0.5f;
  const float salt = st[2];
  const float f[3] = {-bx + (acc.flx + salt * acc.fex),
                      -by + (acc.fly + salt * acc.fey),
                      -bz + (acc.flz + salt * acc.fez)};
  const float m = masses[i];
  const size_t o = ((size_t)r * N + i) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float kick = half_kick * f[c] / m;
    const float x = P[3 * i + c];
    float v = vel[o + c];
    if (trail) v = v + kick;                   // trailing half-B of i - 1
    float nv = v + kick;                       // leading half-B of step i
    float nx = x + half_dt * nv;               // A
    nv = c1 * nv + noise[o + c];               // O (pre-scaled noise)
    nx = nx + half_dt * nv;                    // A
    npos[o + c] = lead ? nx : x;
    nvel[o + c] = lead ? nv : v;
  }
}

}  // namespace

// bias: the (R, 8) umbrella rows, or null for the bias=False variant.
extern "C" int fused_baoab_launch(
    const float* pos, const float* vel, const float* noise,
    const float* step_par, const float* bias, const int* bonds,
    const float* bond_par, const int* angles, const float* ang_par,
    const int* quads, const float* quad_par, const int* slot_idx,
    const float* slot_sign, const float* sigma, const float* sqrt_eps,
    const float* charge, const uint8_t* mask, const float* masses,
    float* npos, float* nvel, int R, int N, int ld, int B, int A, int Q,
    int W, int S, float coulomb, float c1, float half_kick, float half_dt,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const md::BondedTables tab{bonds, bond_par, angles, ang_par,
                             quads, quad_par, B, A, Q};
  const dim3 grid(ld / kTile, R);
  if (bias != nullptr)
    fused_baoab_kernel<true><<<grid, kTile, 0, st>>>(
        pos, vel, noise, step_par, bias, tab, slot_idx, slot_sign, sigma,
        sqrt_eps, charge, mask, masses, npos, nvel, N, ld, W, S, coulomb, c1,
        half_kick, half_dt);
  else
    fused_baoab_kernel<false><<<grid, kTile, 0, st>>>(
        pos, vel, noise, step_par, nullptr, tab, slot_idx, slot_sign, sigma,
        sqrt_eps, charge, mask, masses, npos, nvel, N, ld, W, S, coulomb, c1,
        half_kick, half_dt);
  return static_cast<int>(cudaGetLastError());
}
