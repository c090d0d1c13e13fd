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
// What bounds it on an H100: operations.  The nonbonded sum is O(N^2) per
// replica: each kept unordered pair at about 46 flops for the two force
// rows, 7.4e10 flops at R = 384, N = 2881, 1.1 ms at 67 TFLOP/s fp32; the
// bonded terms and the update are O(N) and the bytes (positions,
// velocities and noise in, positions and velocities out, the pack's
// 1.1 MB exclusion bits) are a few tens of MB.
//
// Design.  One block per replica; the replica's nonbonded force rows (ld x 3
// floats) live in shared memory where they fit and in device memory above,
// summed without atomics either way:
//   * The atoms are cut into n_t = ld / 64 tiles.  Each unordered pair of
//     tiles (I < J) is visited once, by one warp, which adds the pair
//     forces to both tiles' rows (Newton's third law): lane l owns i-atoms
//     64 I + l and 64 I + 32 + l, with their sums in registers, and walks
//     each 32-atom half of J in 32 steps, lane l meeting j = (l + s) % 32
//     at step s; the j-side sums ride along, handed one lane down by a
//     shuffle after every step, so after 32 steps each is home.  A
//     diagonal tile (I = J) is walked the same way, its lower half against
//     its upper half, then each half against itself over 16 steps.
//   * The tile pairs are scheduled as a round-robin tournament (the circle
//     method: n_t - 1 rounds of n_t / 2 disjoint pairs, n_t even since ld
//     is a multiple of 128); within a round no two warps touch the same
//     rows, so each warp adds its sums to shared memory directly, and a
//     barrier closes the round.  The schedule is fixed, so every row's sum
//     is taken in one order: bitwise identical run to run, and run_fused's
//     decisions do not depend on the chunk size.
//   * Per pair: one reciprocal square root (rinv = rsqrt(r2), inv_r2 =
//     rinv^2) and products, no division: tt = sigma^2 inv_r2, c = (24 eps
//     (2 s6^2 - s6) + salt coulomb qq rinv) inv_r2 = c_lj + salt c_el,
//     with 24 sqrt(eps_i), salt coulomb q_i and sigma_i / 2 hoisted per
//     atom (the salt scale per pair: one force row, not two).
//   * The exclusion mask comes as the pack's per-tile-pair "all kept"
//     flags and 32-bit rows of mask bits (lj_forces/ops.py build_pack,
//     once per system).  A tile pair whose flag is set (462 of 506
//     128 x 128 tiles off the diagonal on the 2881-atom chain) runs without
//     the mask; elsewhere a lane reads one word of bits per i-atom and
//     half tile, and a masked pair gets r2 += 1 - m, so it stays finite and
//     adds exactly zero.  The mask is symmetric (exclusions are pairs).
//   * After a barrier the block's threads take one atom at a time: the
//     bonded force from its <= S signed edge slots (chain_forces/ref
//     bonded_slots, each slot's term recomputed from the positions with
//     chain_forces.cu's device code, md_terms.cuh), f = fb + f_nb, and the
//     masked update.  Positions and velocities are double-buffered (read
//     pos/vel, write npos/nvel); noise comes in pre-scaled (noise_scale *
//     xi, drawn by md/noise.py); energies are not an output.
// The block is n_t / 2 warps (at most 24), so every warp of a round has a
// tile pair; shared memory is 1.5 KB of staged j atoms per warp plus, in
// the kRowsShared layout, ld x 12 bytes of force rows (70 KB at N = 2881).
// Past ld = 16,256 the rows do not fit beside 24 warps' staging, so the
// wrapper (fused_propagate/ops.py rows_in_shared, by N alone) gives each
// replica an ld x 3 float scratch in device memory instead, reached by the
// same code through a global pointer (the L2 holds it; pair_tiles.cuh's
// pattern): the same sums in the same order, and no ceiling on N.
#include <cuda_runtime.h>
#include <stdint.h>

#include "md_terms.cuh"

namespace {

constexpr int kFT = 64;          // atoms per tile; PAIR_TILE in lj_forces/ops.py
constexpr int kMaxWarps = 24;
constexpr int kMaxSmem = 232448;

// Per-atom constants of the pair sum, hoisted: position, sigma / 2,
// 24 sqrt(eps) (i side) or sqrt(eps) (j side), salt coulomb q (i) or q (j).
struct Atom {
  float x, y, z, hs, e, q;
};

struct Frc {
  float x = 0.f, y = 0.f, z = 0.f;
};

// 1 / sqrt(x) for x > 0 and not subnormal (r2 of two atoms, or >= 1 for a
// masked pair): one MUFU instruction, within 2^-22.9 relative, as rsqrtf.
__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// c with F_i += c d, F_j -= c d, d = x_i - x_j: (c_lj + salt c_el) =
// (24 eps (2 s6^2 - s6) + salt coulomb qq rinv) inv_r2, with 24 sqrt(eps_i)
// and salt coulomb q_i carried by i.  kMasked: the pair's 0/1 mask m
// guards r2 and scales c.
template <bool kMasked>
__device__ __forceinline__ float pair_coef(const Atom& a, float jx, float jy,
                                           float jz, float jhs, float je,
                                           float jq, float m, float& dx,
                                           float& dy, float& dz) {
  dx = a.x - jx;
  dy = a.y - jy;
  dz = a.z - jz;
  float r2 = dx * dx + dy * dy + dz * dz;
  if (kMasked) r2 += 1.0f - m;
  const float rinv = rsqrt_approx(r2);
  const float inv_r2 = rinv * rinv;
  const float sig = a.hs + jhs;
  const float tt = sig * sig * inv_r2;
  const float s6 = tt * (tt * tt);
  const float c = (a.e * je * s6 * (2.0f * s6 - 1.0f) + a.q * jq * rinv) *
                  inv_r2;
  return kMasked ? c * m : c;
}

struct Ctx {
  const float* P;           // this replica's (N, 3) positions
  const float* sigma;
  const float* sqrt_eps;
  const float* charge;
  const uint32_t* bits;     // (ld, ld / 32) mask bits
  float4* jxq;              // this warp's staged j atoms: x, y, z, q
  float2* jse;              //   sigma / 2, sqrt(eps)
  float *fx, *fy, *fz;      // the replica's force rows (shared)
  int N, nw;                // atoms; words of mask bits per row
  float qscale;             // salt scale x coulomb
};

__device__ __forceinline__ Atom load_i(const Ctx& c, int i) {
  if (i >= c.N) return {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  return {c.P[3 * i],           c.P[3 * i + 1],
          c.P[3 * i + 2],       0.5f * c.sigma[i],
          24.0f * c.sqrt_eps[i], c.qscale * c.charge[i]};
}

// Stage tile t's atoms into this warp's j buffers (zeros past N).
__device__ __forceinline__ void stage_j(const Ctx& c, int t, int lane) {
  __syncwarp();
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int jl = lane + 32 * u, j = kFT * t + jl;
    if (j < c.N) {
      c.jxq[jl] = make_float4(c.P[3 * j], c.P[3 * j + 1], c.P[3 * j + 2],
                              c.charge[j]);
      c.jse[jl] = make_float2(0.5f * c.sigma[j], c.sqrt_eps[j]);
    } else {
      c.jxq[jl] = make_float4(0.f, 0.f, 0.f, 0.f);
      c.jse[jl] = make_float2(0.f, 0.f);
    }
  }
  __syncwarp();
}

__device__ __forceinline__ void add_row(const Ctx& c, int i, const Frc& f) {
  c.fx[i] += f.x;
  c.fy[i] += f.y;
  c.fz[i] += f.z;
}

// Tiles I < J: every pair once, both sides.
template <bool kMasked>
__device__ void tile_pair(const Ctx& c, int I, int J, int lane) {
  stage_j(c, J, lane);
  const int i0 = kFT * I + lane, i1 = i0 + 32;
  const Atom a0 = load_i(c, i0), a1 = load_i(c, i1);
  Frc f0, f1;
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    uint32_t b0 = 0u, b1 = 0u;
    if (kMasked) {
      b0 = c.bits[(size_t)i0 * c.nw + 2 * J + half];
      b1 = c.bits[(size_t)i1 * c.nw + 2 * J + half];
    }
    Frc fj;
#pragma unroll 4
    for (int s = 0; s < 32; ++s) {
      const int jl = (lane + s) & 31;
      const float4 xq = c.jxq[32 * half + jl];
      const float2 se = c.jse[32 * half + jl];
      float dx, dy, dz;
      float cf = pair_coef<kMasked>(a0, xq.x, xq.y, xq.z, se.x, se.y, xq.w,
                                    (float)((b0 >> jl) & 1u), dx, dy, dz);
      f0.x += cf * dx;
      f0.y += cf * dy;
      f0.z += cf * dz;
      fj.x -= cf * dx;
      fj.y -= cf * dy;
      fj.z -= cf * dz;
      cf = pair_coef<kMasked>(a1, xq.x, xq.y, xq.z, se.x, se.y, xq.w,
                              (float)((b1 >> jl) & 1u), dx, dy, dz);
      f1.x += cf * dx;
      f1.y += cf * dy;
      f1.z += cf * dz;
      fj.x -= cf * dx;
      fj.y -= cf * dy;
      fj.z -= cf * dz;
      // lane l holds j = (l + s) % 32; hand it one lane down
      fj.x = __shfl_sync(0xffffffffu, fj.x, (lane + 1) & 31);
      fj.y = __shfl_sync(0xffffffffu, fj.y, (lane + 1) & 31);
      fj.z = __shfl_sync(0xffffffffu, fj.z, (lane + 1) & 31);
    }
    add_row(c, kFT * J + 32 * half + lane, fj);   // home after 32 steps
  }
  add_row(c, i0, f0);
  add_row(c, i1, f1);
}

// This lane's atom a against the 32 staged atoms of half h (mask word
// bits), lane l meeting j = (l + s) % 32 at steps s = first .. last; at
// s = 16 of a half with itself only lanes < 16 (the pair (l, l + 16) once).
// Adds to fi; returns the j-side sums brought home (lane l: j = l).
__device__ __forceinline__ Frc sweep_half(const Ctx& c, const Atom& a,
                                          uint32_t bits, int h, int first,
                                          int last, bool self, int lane,
                                          Frc& fi) {
  Frc fj;
#pragma unroll 4
  for (int s = first; s <= last; ++s) {
    const int jl = (lane + s) & 31;
    if (!(self && s == 16 && lane >= 16)) {
      const float4 xq = c.jxq[32 * h + jl];
      const float2 se = c.jse[32 * h + jl];
      float dx, dy, dz;
      const float cf = pair_coef<true>(a, xq.x, xq.y, xq.z, se.x, se.y, xq.w,
                                       (float)((bits >> jl) & 1u), dx, dy,
                                       dz);
      fi.x += cf * dx;
      fi.y += cf * dy;
      fi.z += cf * dz;
      fj.x -= cf * dx;
      fj.y -= cf * dy;
      fj.z -= cf * dz;
    }
    fj.x = __shfl_sync(0xffffffffu, fj.x, (lane + 1) & 31);
    fj.y = __shfl_sync(0xffffffffu, fj.y, (lane + 1) & 31);
    fj.z = __shfl_sync(0xffffffffu, fj.z, (lane + 1) & 31);
  }
  const int from = (lane - last - 1) & 31;      // lane l holds l + last + 1
  fj.x = __shfl_sync(0xffffffffu, fj.x, from);
  fj.y = __shfl_sync(0xffffffffu, fj.y, from);
  fj.z = __shfl_sync(0xffffffffu, fj.z, from);
  return fj;
}

__device__ __forceinline__ void add(Frc& f, const Frc& g) {
  f.x += g.x;
  f.y += g.y;
  f.z += g.z;
}

// Tile I with itself, every unordered pair once (self pairs are never
// formed): the lower half (lane l's i0) against the upper half, whose sums
// come home to the lanes that own those atoms (i1 = i0 + 32), then each
// half against itself.
__device__ void tile_diag(const Ctx& c, int I, int lane) {
  stage_j(c, I, lane);
  const int i0 = kFT * I + lane, i1 = i0 + 32;
  const Atom a0 = load_i(c, i0), a1 = load_i(c, i1);
  const uint32_t* w0 = c.bits + (size_t)i0 * c.nw + 2 * I;
  const uint32_t* w1 = c.bits + (size_t)i1 * c.nw + 2 * I;
  Frc f0, f1;
  Frc fj = sweep_half(c, a0, w0[1], 1, 0, 31, false, lane, f0);
  add(f1, fj);
  fj = sweep_half(c, a0, w0[0], 0, 1, 16, true, lane, f0);
  add(f0, fj);
  fj = sweep_half(c, a1, w1[1], 1, 1, 16, true, lane, f1);
  add(f1, fj);
  add_row(c, i0, f0);
  add_row(c, i1, f1);
}

// kRowsShared: the force rows in shared memory after the staging buffers;
// else rows_g[r] (3, ld) in device memory.
template <bool kBias, bool kRowsShared>
__global__ void __launch_bounds__(32 * kMaxWarps, 1) fused_baoab_kernel(
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ noise, const float* __restrict__ step_par,
    const float* __restrict__ bias, md::BondedTables tab,
    const int* __restrict__ slot_idx, const float* __restrict__ slot_sign,
    const float* __restrict__ sigma, const float* __restrict__ sqrt_eps,
    const float* __restrict__ charge, const uint32_t* __restrict__ bits,
    const uint8_t* __restrict__ kept, const float* __restrict__ masses,
    float* __restrict__ rows_g, float* __restrict__ npos,
    float* __restrict__ nvel, int N, int ld, int W, int S, float coulomb,
    float c1, float half_kick, float half_dt) {
  extern __shared__ float4 smem4[];
  const int r = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, n_warps = blockDim.x / 32;
  const int n_t = ld / kFT;
  const float* st = step_par + (size_t)r * 8;

  Ctx c;
  c.P = pos + (size_t)r * N * 3;
  c.sigma = sigma;
  c.sqrt_eps = sqrt_eps;
  c.charge = charge;
  c.bits = bits;
  c.jxq = smem4 + warp * kFT;
  c.jse = reinterpret_cast<float2*>(smem4 + n_warps * kFT) + warp * kFT;
  if (kRowsShared)
    c.fx = reinterpret_cast<float*>(reinterpret_cast<float2*>(
                                        smem4 + n_warps * kFT) +
                                    n_warps * kFT);
  else
    c.fx = rows_g + (size_t)r * 3 * ld;
  c.fy = c.fx + ld;
  c.fz = c.fy + ld;
  c.N = N;
  c.nw = ld / 32;
  c.qscale = st[2] * coulomb;

  for (int i = tid; i < ld; i += blockDim.x) c.fx[i] = c.fy[i] = c.fz[i] = 0.f;
  __syncthreads();
  for (int t = warp; t < n_t; t += n_warps) tile_diag(c, t, lane);
  __syncthreads();
  // round-robin tournament: round u pairs (n_t - 1, u) and
  // ((u + k) % (n_t - 1), (u - k) % (n_t - 1)) for k = 1 .. n_t / 2 - 1
  const int n_odd = n_t - 1, n_pairs = n_t / 2;
  for (int u = 0; u < n_odd; ++u) {
    for (int k = warp; k < n_pairs; k += n_warps) {
      int a = n_odd, b = u;
      if (k > 0) {
        a = (u + k) % n_odd;
        b = (u - k + n_odd) % n_odd;
      }
      const int I = min(a, b), J = max(a, b);
      if (kept[I * n_t + J])
        tile_pair<false>(c, I, J, lane);
      else
        tile_pair<true>(c, I, J, lane);
    }
    __syncthreads();
  }

  // bonded: force = -sum_s sign[i, s] * edge[slot_idx[i, s]], slot order;
  // then f = fb + f_nb and the update, one atom per thread
  const float* brow = kBias ? bias + (size_t)r * 8 : nullptr;
  const bool trail = st[0] > 0.5f, lead = st[1] > 0.5f;
  for (int i = tid; i < N; i += blockDim.x) {
    float bx = 0.f, by = 0.f, bz = 0.f;
    for (int s = 0; s < S; ++s) {
      const float sg = slot_sign[i * S + s];
      if (sg == 0.f) continue;                 // padding slot
      const md::V3 e =
          md::edge_of_slot<kBias>(c.P, tab, slot_idx[i * S + s], W, brow);
      bx += sg * e.x;
      by += sg * e.y;
      bz += sg * e.z;
    }
    const float f[3] = {-bx + c.fx[i], -by + c.fy[i], -bz + c.fz[i]};
    const float m = masses[i];
    const size_t o = ((size_t)r * N + i) * 3;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float kick = half_kick * f[d] / m;
      const float x = c.P[3 * i + d];
      float v = vel[o + d];
      if (trail) v = v + kick;                 // trailing half-B of i - 1
      float nv = v + kick;                     // leading half-B of step i
      float nx = x + half_dt * nv;             // A
      nv = c1 * nv + noise[o + d];             // O (pre-scaled noise)
      nx = nx + half_dt * nv;                  // A
      npos[o + d] = lead ? nx : x;
      nvel[o + d] = lead ? nv : v;
    }
  }
}

template <bool kBias>
int launch(bool shared, dim3 grid, int threads, int smem, cudaStream_t st,
           const float* pos, const float* vel, const float* noise,
           const float* step_par, const float* bias,
           const md::BondedTables& tab, const int* slot_idx,
           const float* slot_sign, const float* sigma, const float* sqrt_eps,
           const float* charge, const uint32_t* bits, const uint8_t* kept,
           const float* masses, float* rows_g, float* npos, float* nvel,
           int N, int ld, int W, int S, float coulomb, float c1,
           float half_kick, float half_dt) {
  auto kernel = fused_baoab_kernel<kBias, true>;
  if (!shared) kernel = fused_baoab_kernel<kBias, false>;
  static bool attr_set[2] = {false, false};  // before any graph capture
  if (!attr_set[shared]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set[shared] = true;
  }
  kernel<<<grid, threads, smem, st>>>(
      pos, vel, noise, step_par, bias, tab, slot_idx, slot_sign, sigma,
      sqrt_eps, charge, bits, kept, masses, rows_g, npos, nvel, N, ld, W, S,
      coulomb, c1, half_kick, half_dt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bias: the (R, 8) umbrella rows, or null for the bias=False variant;
// rows_g: an (R, 3, ld) scratch for the force rows, or null to keep them in
// shared memory (they must fit: fused_propagate/ops.py rows_in_shared).
extern "C" int fused_baoab_launch(
    const float* pos, const float* vel, const float* noise,
    const float* step_par, const float* bias, const int* bonds,
    const float* bond_par, const int* angles, const float* ang_par,
    const int* quads, const float* quad_par, const int* slot_idx,
    const float* slot_sign, const float* sigma, const float* sqrt_eps,
    const float* charge, const uint32_t* bits, const uint8_t* kept,
    const float* masses, float* rows_g, float* npos, float* nvel, int R,
    int N, int ld, int B, int A, int Q, int W, int S, float coulomb,
    float c1, float half_kick, float half_dt, void* stream) {
  if (R == 0) return 0;
  const bool shared = rows_g == nullptr;
  const int n_half = ld / kFT / 2;
  const int n_warps = n_half < kMaxWarps ? n_half : kMaxWarps;
  const int smem = n_warps * kFT * (16 + 8) + (shared ? ld * 3 * 4 : 0);
  if (ld % (2 * kFT) != 0 || ld < N || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const md::BondedTables tab{bonds, bond_par, angles, ang_par,
                             quads, quad_par, B, A, Q};
  const dim3 grid(R);
  if (bias != nullptr)
    return launch<true>(shared, grid, 32 * n_warps, smem, st, pos, vel,
                        noise, step_par, bias, tab, slot_idx, slot_sign,
                        sigma, sqrt_eps, charge, bits, kept, masses, rows_g,
                        npos, nvel, N, ld, W, S, coulomb, c1, half_kick,
                        half_dt);
  return launch<false>(shared, grid, 32 * n_warps, smem, st, pos, vel, noise,
                       step_par, nullptr, tab, slot_idx, slot_sign, sigma,
                       sqrt_eps, charge, bits, kept, masses, rows_g, npos,
                       nvel, N, ld, W, S, coulomb, c1, half_kick, half_dt);
}
