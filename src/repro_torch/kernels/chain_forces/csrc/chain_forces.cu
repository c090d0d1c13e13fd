// Bonded forces (harmonic bonds, harmonic angles, cosine torsions) and the
// total bonded energy for a replica stack, written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/chain_forces/kernel.py
//   chain_forces_kernel_batched (pl.pallas_call at :199, body
//   bonded_scatter_rows at :71), both variants: bias=False, and bias=True,
//   which adds the umbrella torque on the phi/psi feature torsions from a
//   per-replica (R, 8) row [c0, c1, k0, k1, 0...] (chain_forces/ops.py
//   pack_bias).  The variant is a template argument, so the bias=False
//   instantiation compiles without a trace of the bias.
//
// What bounds it on an H100: bytes.  The call reads the positions once and
// writes the forces once (R * N * 24 bytes: 26.5 MB at R = 384, N = 2881,
// 7.9 us at 3.35 TB/s) and does a few hundred flops per term (3.6 us at
// 67 TFLOP/s fp32 there).
//
// Design: the TPU kernel gathers and scatters with one-hot matrix products
// on the MXU (an (Np, Tp) f32 matrix, 312 MB at N = 2881).  Here indices
// are read directly, and no per-edge scratch leaves the block (an earlier
// design wrote an (R, 6W, 3) edge scratch, 80 MB at R = 384, and read it
// back in a second launch).
//   * At pack time (chain_forces/ops.py block_tables, host side) the atoms
//     are cut into blocks of kBlockAtoms.  For each block the table lists
//     every term (bond, angle or torsion) that touches one of its atoms, in
//     ascending term order, with the offset of its edge vectors in the
//     block's local edge array (a bond has 1 edge, an angle 2, a torsion 3)
//     and a flag on the one block that owns its energy (the block of the
//     term's first atom); each atom's <= S signed slots are renumbered into
//     its block's local edges, as one int per slot (local edge << 2 | 1
//     for +1, 2 for -1, 0 for padding) in an (S, N) table, so the threads
//     of a block read each slot rank coalesced.  The tables are built from
//     the topology alone: a non-local topology only lists more terms per
//     block.
//   * bonded_block_kernel, one block per (atom block, replica): its threads
//     compute the listed terms' per-edge gradients (the term code lives in
//     ../../csrc/md_terms.cuh, shared with fused_baoab.cu: the same guard
//     epsilons, clip bounds and atan2 dihedral as ref._edge_grads) into
//     shared memory; after a barrier each thread sums one atom's <= S edge
//     slots in slot order (the plain version's order), so the forces are
//     those of a two-phase design with a scratch.  A term that touches two
//     blocks is computed in both.  The owned terms' energies are summed per
//     thread, then over the block in a fixed tree, into an (R, n_blocks)
//     scratch.
//   * bonded_energy_kernel adds each replica's block sums in block order.
// There are no float atomics, so results are bitwise identical run to run
// (what keeps run_fused's decisions independent of the chunk size).
#include <cuda_runtime.h>

#include "md_terms.cuh"

namespace {

using md::V3;

constexpr int kBlockAtoms = 256;   // atoms (and threads) per block;
                                   // BLOCK_ATOMS in chain_forces/ops.py
constexpr int kOwner = 1 << 30;    // the owner flag of a listed term
constexpr int kMaxSmem = 232448;   // shared memory one block may use

__device__ __forceinline__ void store3(float* e, int slot, V3 v) {
  e[3 * slot] = v.x;
  e[3 * slot + 1] = v.y;
  e[3 * slot + 2] = v.z;
}

// Block b of replica r: the edges of the block's terms into shared memory,
// then each atom's slot sum, and the owned terms' energy into e_part[r, b].
// A listed term t (its flag masked off) is bond t, angle t - B or torsion
// t - B - A; its edges go to local slots term_edge[k], + 1, + 2 in role
// order (bond d | angle v1, v2 | torsion b0, b1, b2).
template <bool kBias>
__global__ void __launch_bounds__(kBlockAtoms) bonded_block_kernel(
    const float* __restrict__ pos, md::BondedTables tab,
    const float* __restrict__ bias, const int* __restrict__ term_ptr,
    const int* __restrict__ terms, const int* __restrict__ term_edge,
    const int* __restrict__ slot_code, float* __restrict__ force,
    float* __restrict__ e_part, int N, int S) {
  extern __shared__ float edges[];
  __shared__ float red[kBlockAtoms];
  const int b = blockIdx.x, r = blockIdx.y, tid = threadIdx.x;
  const int B = tab.B, A = tab.A;
  const float* P = pos + (size_t)r * N * 3;
  const float* brow = kBias ? bias + (size_t)r * 8 : nullptr;
  float e = 0.f;
  for (int k = term_ptr[b] + tid; k < term_ptr[b + 1]; k += kBlockAtoms) {
    const int v = terms[k];
    const int t = v & (kOwner - 1);
    float* E = edges + 3 * term_edge[k];
    V3 x, y, z;
    float et;
    if (t < B) {
      et = md::bond_term(P, tab, t, x);
      store3(E, 0, x);
    } else if (t < B + A) {
      et = md::angle_term(P, tab, t - B, x, y);
      store3(E, 0, x);
      store3(E, 1, y);
    } else {
      et = md::torsion_term<kBias>(P, tab, t - B - A, brow, x, y, z);
      store3(E, 0, x);
      store3(E, 1, y);
      store3(E, 2, z);
    }
    if (v & kOwner) e += et;
  }
  __syncthreads();
  const int a = b * kBlockAtoms + tid;
  if (a < N) {
    float fx = 0.0f, fy = 0.0f, fz = 0.0f;
#pragma unroll 4
    for (int s = 0; s < S; ++s) {
      const int c = slot_code[(size_t)s * N + a];
      const float sg = (c & 1) ? 1.0f : ((c & 2) ? -1.0f : 0.0f);
      const float* E = edges + 3 * (c >> 2);
      fx += sg * E[0];
      fy += sg * E[1];
      fz += sg * E[2];
    }
    float* F = force + ((size_t)r * N + a) * 3;
    F[0] = -fx;
    F[1] = -fy;
    F[2] = -fz;
  }
  red[tid] = e;
  __syncthreads();
  for (int s = kBlockAtoms / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  if (tid == 0) e_part[(size_t)r * gridDim.x + b] = red[0];
}

// energy[r] = the in-order sum of replica r's block sums.
__global__ void bonded_energy_kernel(const float* __restrict__ e_part,
                                     float* __restrict__ energy, int R,
                                     int n_blocks) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float* ep = e_part + (size_t)r * n_blocks;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += ep[b];
  energy[r] = s;
}

template <bool kBias>
int launch(dim3 grid, int smem, cudaStream_t st, const float* pos,
           const md::BondedTables& tab, const float* bias,
           const int* term_ptr, const int* terms, const int* term_edge,
           const int* slot_code, float* force, float* e_part, int N,
           int S) {
  // The shared-memory opt-in holds for the current device only: set it on
  // a device's first call, before any graph capture on it.
  constexpr int kMaxDevices = 64;
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !attr_set[dev]) {
    err = cudaFuncSetAttribute(bonded_block_kernel<kBias>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem - kBlockAtoms * 4);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) attr_set[dev] = true;
  }
  bonded_block_kernel<kBias><<<grid, kBlockAtoms, smem, st>>>(
      pos, tab, bias, term_ptr, terms, term_edge, slot_code, force, e_part,
      N, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bias: the (R, 8) umbrella rows, or null for the bias=False variant;
// term_ptr / terms / term_edge: the per-block term table (n_blocks + 1
// offsets); slot_code: (S, N) local edge slots with their signs;
// max_edges: the most local edges of any block; e_part: an (R, n_blocks)
// scratch.
extern "C" int chain_forces_launch(
    const float* pos, const int* bonds, const float* bond_par,
    const int* angles, const float* ang_par, const int* quads,
    const float* quad_par, const int* term_ptr, const int* terms,
    const int* term_edge, const int* slot_code, const float* bias,
    float* e_part, float* force, float* energy, int R, int N, int B, int A,
    int Q, int S, int max_edges, void* stream) {
  if (R == 0 || N == 0) return 0;
  const int n_blocks = (N + kBlockAtoms - 1) / kBlockAtoms;
  const long smem = 12L * max_edges;
  if (smem + kBlockAtoms * 4 > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const md::BondedTables tab{bonds, bond_par, angles, ang_par,
                             quads, quad_par, B, A, Q};
  const dim3 grid(n_blocks, R);
  const int code =
      bias != nullptr
          ? launch<true>(grid, (int)smem, st, pos, tab, bias, term_ptr, terms,
                         term_edge, slot_code, force, e_part, N, S)
          : launch<false>(grid, (int)smem, st, pos, tab, nullptr, term_ptr,
                          terms, term_edge, slot_code, force, e_part, N, S);
  if (code != 0) return code;
  bonded_energy_kernel<<<(R + 127) / 128, 128, 0, st>>>(e_part, energy, R,
                                                        n_blocks);
  return static_cast<int>(cudaGetLastError());
}
