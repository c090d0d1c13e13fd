// Bonded forces (harmonic bonds, harmonic angles, cosine torsions) and the
// total bonded energy for a replica stack, written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/chain_forces/kernel.py
//   chain_forces_kernel_batched (pl.pallas_call at :199, body
//   bonded_scatter_rows at :71), both variants: bias=False, and bias=True,
//   which adds the umbrella torque on the phi/psi feature torsions from a
//   per-replica (R, 8) row [c0, c1, k0, k1, 0...] (chain_forces/ops.py
//   _pack_bias).  The variant is a template argument, so the bias=False
//   instantiation compiles without a trace of the bias.
//
// What bounds it on an H100: neither rate.  The call reads the positions
// once and writes the forces once (R * N * 24 bytes, 4.4 MB at R = 64,
// N = 2881: about 1.3 us at 3.35 TB/s) and does a few hundred flops per
// term (well under 1 us at 67 TFLOP/s fp32), so its time is three launch
// latencies plus the dependent index-then-position loads of each term.
//
// Design: the TPU kernel gathers and scatters with one-hot matrix products
// on the MXU (an (Np, Tp) f32 matrix, 312 MB at N = 2881).  Here indices
// are read directly.
//   Phase 1 (bonded_edges_kernel): one thread per (replica, term).  It
//     loads its 2-4 atoms by index, computes the same per-edge gradient
//     vectors as bonded_scatter_rows / ref._edge_grads (same +1e-12 and
//     +1e-9 guards, arccos argument clipped to +-(1 - 1e-6) with the
//     interior mask, atan2 dihedral; the term code lives in
//     ../../csrc/md_terms.cuh, shared with fused_baoab.cu) and writes
//     them to an (R, 6W, 3) scratch (13 MB at R = 64, resident in the
//     50 MB L2), plus its term energy to an (R, 3, W) scratch.
//   Phase 2 (bonded_gather_kernel): one thread per (replica, atom) sums the
//     <= S signed edge slots of bonded_slots in slot order.
//   Energy (bonded_energy_kernel): one block per replica reduces each term
//     class in a fixed tree order.
// There are no float atomics, so results are bitwise identical run to run
// (what keeps run_fused's decisions independent of the chunk size).
#include <cuda_runtime.h>

#include "md_terms.cuh"

namespace {

using md::V3;

__device__ __forceinline__ void store3(float* e, int slot, V3 v) {
  e[3 * slot] = v.x;
  e[3 * slot + 1] = v.y;
  e[3 * slot + 2] = v.z;
}

// Edge slot ``role * W + w``: role 0 bond d, 1 angle v1 arm, 2 angle v2 arm,
// 3 torsion b0, 4 torsion b1, 5 torsion b2 (the layout of bonded_slots).
template <bool kBias>
__global__ void bonded_edges_kernel(const float* __restrict__ pos,
                                    md::BondedTables tab,
                                    const float* __restrict__ bias,
                                    float* __restrict__ edges,
                                    float* __restrict__ term_e, int N,
                                    int W) {
  const int r = blockIdx.y;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int B = tab.B, A = tab.A;
  if (t >= B + A + tab.Q) return;
  const float* P = pos + (size_t)r * N * 3;
  float* E = edges + (size_t)r * 6 * W * 3;
  float* TE = term_e + (size_t)r * 3 * W;
  V3 a, b, c;
  if (t < B) {
    TE[t] = md::bond_term(P, tab, t, a);
    store3(E, t, a);
  } else if (t < B + A) {
    const int w = t - B;
    TE[W + w] = md::angle_term(P, tab, w, a, b);
    store3(E, W + w, a);
    store3(E, 2 * W + w, b);
  } else {
    const int w = t - B - A;
    TE[2 * W + w] = md::torsion_term<kBias>(
        P, tab, w, kBias ? bias + (size_t)r * 8 : nullptr, a, b, c);
    store3(E, 3 * W + w, a);
    store3(E, 4 * W + w, b);
    store3(E, 5 * W + w, c);
  }
}

// force[r, a] = -sum_s sign[a, s] * edges[r, idx[a, s]], in slot order.
__global__ void bonded_gather_kernel(const float* __restrict__ edges,
                                     const int* __restrict__ slot_idx,
                                     const float* __restrict__ slot_sign,
                                     float* __restrict__ force, int N, int W,
                                     int S) {
  const int r = blockIdx.y;
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= N) return;
  const float* E = edges + (size_t)r * 6 * W * 3;
  float fx = 0.0f, fy = 0.0f, fz = 0.0f;
  for (int s = 0; s < S; ++s) {
    const int f = slot_idx[a * S + s];
    const float sg = slot_sign[a * S + s];
    fx += sg * E[3 * f];
    fy += sg * E[3 * f + 1];
    fz += sg * E[3 * f + 2];
  }
  float* F = force + ((size_t)r * N + a) * 3;
  F[0] = -fx;
  F[1] = -fy;
  F[2] = -fz;
}

constexpr int kEnergyThreads = 256;

// energy[r] = (sum bonds + sum angles) + sum torsions, each class reduced
// by one block in a fixed order (strided per-thread sums, then a tree).
__global__ void bonded_energy_kernel(const float* __restrict__ term_e,
                                     float* __restrict__ energy, int B, int A,
                                     int Q, int W) {
  __shared__ float sh[kEnergyThreads];
  const int r = blockIdx.x, tid = threadIdx.x;
  const float* TE = term_e + (size_t)r * 3 * W;
  const int counts[3] = {B, A, Q};
  float cls[3];
  for (int c = 0; c < 3; ++c) {
    float acc = 0.0f;
    for (int i = tid; i < counts[c]; i += kEnergyThreads) acc += TE[c * W + i];
    sh[tid] = acc;
    __syncthreads();
    for (int s = kEnergyThreads / 2; s > 0; s >>= 1) {
      if (tid < s) sh[tid] += sh[tid + s];
      __syncthreads();
    }
    cls[c] = sh[0];
    __syncthreads();
  }
  if (tid == 0) energy[r] = (cls[0] + cls[1]) + cls[2];
}

}  // namespace

// bias: the (R, 8) umbrella rows, or null for the bias=False variant.
extern "C" int chain_forces_launch(
    const float* pos, const int* bonds, const float* bond_par,
    const int* angles, const float* ang_par, const int* quads,
    const float* quad_par, const int* slot_idx, const float* slot_sign,
    const float* bias, float* edges, float* term_e, float* force,
    float* energy, int R, int N, int B, int A, int Q, int W, int S,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const md::BondedTables tab{bonds, bond_par, angles, ang_par,
                             quads, quad_par, B, A, Q};
  const dim3 grid((B + A + Q + 127) / 128, R);
  if (bias != nullptr)
    bonded_edges_kernel<true><<<grid, 128, 0, st>>>(pos, tab, bias, edges,
                                                    term_e, N, W);
  else
    bonded_edges_kernel<false><<<grid, 128, 0, st>>>(pos, tab, nullptr,
                                                     edges, term_e, N, W);
  bonded_gather_kernel<<<dim3((N + 127) / 128, R), 128, 0, st>>>(
      edges, slot_idx, slot_sign, force, N, W, S);
  bonded_energy_kernel<<<R, kEnergyThreads, 0, st>>>(term_e, energy, B, A, Q,
                                                     W);
  return static_cast<int>(cudaGetLastError());
}
