// Device code shared by the port's force kernels, written once: the bonded
// term gradients (chain_forces.cu, fused_baoab.cu), the nonbonded pair term
// of the neighbor-list kernel (nonbonded_sparse.cu) and its fixed-order
// energy sums.  The all-pairs walk of nonbonded.cu and lj_fluid.cu is
// pair_tiles.cuh.  The TPU kernels share
// the same math the same way: fused_propagate/kernel.py calls
// chain_forces/kernel.py:bonded_scatter_rows and
// lj_forces/kernel.py:nonbonded_pair_rows.
//
// Formulas, guard epsilons and clip bounds follow the PyTorch oracles
// (chain_forces/ref.py, lj_forces/ref.py) term for term.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace md {

constexpr float kClipLo = (float)(-1.0 + 1e-6);
constexpr float kClipHi = (float)(1.0 - 1e-6);
constexpr float kDeg = (float)(180.0 / 3.14159265358979323846);
constexpr int kTile = 128;   // atoms per block of the per-atom kernels; TILE
                             // in lj_forces/ops.py

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p, int atom) {
  return {p[3 * atom], p[3 * atom + 1], p[3 * atom + 2]};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

// jnp.mod(d + 180, 360) - 180: a floor-mod, the remainder takes the sign of
// the divisor.
__device__ __forceinline__ float wrap_deg(float d) {
  float rem = fmodf(d + 180.0f, 360.0f);
  if (rem != 0.0f && rem < 0.0f) rem += 360.0f;
  return rem - 180.0f;
}

// The bonded topology as the kernels read it (see chain_forces/ops.py).
struct BondedTables {
  const int* bonds;        // (B, 2)
  const float* bond_par;   // (2, B): r0, k
  const int* angles;       // (A, 3)
  const float* ang_par;    // (2, A): theta0, k
  const int* quads;        // (Q, 4); the last two are the phi, psi quads
  const float* quad_par;   // (3, Q): n, k, phase
  int B, A, Q;
};

// Per-edge gradients of one term (dE/d edge vector), the rows of
// ref._edge_grads.  Edge slot role * W + w: role 0 bond d, 1 angle v1 arm,
// 2 angle v2 arm, 3 torsion b0, 4 torsion b1, 5 torsion b2.  Each returns
// the term's energy.

// bond w: E = k (r - r0)^2
__device__ __forceinline__ float bond_term(const float* P,
                                           const BondedTables& t, int w,
                                           V3& e0) {
  const V3 pi = load3(P, t.bonds[2 * w]), pj = load3(P, t.bonds[2 * w + 1]);
  const V3 d = {pi.x - pj.x + 1e-12f, pi.y - pj.y + 1e-12f,
                pi.z - pj.z + 1e-12f};
  const float rr = sqrtf(dot(d, d));
  const float r0 = t.bond_par[w], k = t.bond_par[t.B + w];
  const float dr = rr - r0;
  const float cb = 2.0f * k * dr / rr;
  e0 = {cb * d.x, cb * d.y, cb * d.z};
  return k * (dr * dr);
}

// angle w: E = k (theta - theta0)^2, arccos of a clipped cosine, the
// gradient gated to the interior of the clip interval
__device__ __forceinline__ float angle_term(const float* P,
                                            const BondedTables& t, int w,
                                            V3& e1, V3& e2) {
  const V3 pb = load3(P, t.angles[3 * w + 1]);
  const V3 v1 = sub(load3(P, t.angles[3 * w]), pb);
  const V3 v2 = sub(load3(P, t.angles[3 * w + 2]), pb);
  const float n1 = sqrtf(dot(v1, v1)), n2 = sqrtf(dot(v2, v2));
  const float den = n1 * n2 + 1e-9f;
  const float d12 = dot(v1, v2);
  const float cosv = d12 / den;
  const float cc = fminf(fmaxf(cosv, kClipLo), kClipHi);
  const float theta = acosf(cc);
  const float t0 = t.ang_par[w], k = t.ang_par[t.A + w];
  const float dth = theta - t0;
  const float interior = (cosv > kClipLo && cosv < kClipHi) ? 1.0f : 0.0f;
  const float g_c =
      2.0f * k * dth * (-1.0f / sqrtf(1.0f - cc * cc)) * interior;
  const float w1 = d12 * n2 / (den * den * (n1 + 1e-12f));
  const float w2 = d12 * n1 / (den * den * (n2 + 1e-12f));
  e1 = {g_c * (v2.x / den - w1 * v1.x), g_c * (v2.y / den - w1 * v1.y),
        g_c * (v2.z / den - w1 * v1.z)};
  e2 = {g_c * (v1.x / den - w2 * v2.x), g_c * (v1.y / den - w2 * v2.y),
        g_c * (v1.z / den - w2 * v2.z)};
  return k * (dth * dth);
}

// torsion w: E = k (1 + cos(n phi - phase)).  With kBias, the umbrella
// torque 2 k_u wrap(deg(phi) - c_u) * 180/pi joins the phi (u = 0) and psi
// (u = 1) quads, the last two, from this replica's bias row
// [c0, c1, k0, k1, ...]; kBias = false compiles it out.
template <bool kBias>
__device__ __forceinline__ float torsion_term(const float* P,
                                              const BondedTables& t, int w,
                                              const float* bias_row, V3& e3,
                                              V3& e4, V3& e5) {
  const int* q = t.quads + 4 * w;
  const V3 p0 = load3(P, q[0]), p1 = load3(P, q[1]);
  const V3 p2 = load3(P, q[2]), p3 = load3(P, q[3]);
  const V3 b0 = sub(p1, p0), b1 = sub(p2, p1), b2 = sub(p3, p2);
  const V3 n1 = cross(b0, b1), n2 = cross(b1, b2);
  const float nb1 = sqrtf(dot(b1, b1));
  const float g = nb1 + 1e-9f;
  const V3 m1 = cross(n1, {b1.x / g, b1.y / g, b1.z / g});
  const float phi = atan2f(dot(m1, n2), dot(n1, n2));
  const float qn = t.quad_par[w], qk = t.quad_par[t.Q + w];
  const float arg = qn * phi - t.quad_par[2 * t.Q + w];
  float torque = -qk * qn * sinf(arg);
  if (kBias) {
    const int u = w - (t.Q - 2);
    if (u >= 0)
      torque += 2.0f * bias_row[2 + u] * wrap_deg(phi * kDeg - bias_row[u]) *
                kDeg;
  }
  const float inv1 = 1.0f / (dot(n1, n1) + 1e-12f);
  const float inv2 = 1.0f / (dot(n2, n2) + 1e-12f);
  const float invb = 1.0f / (nb1 + 1e-12f);
  const float c0 = torque * -nb1 * inv1;       // dE/db0 = c0 n1
  const float c2 = torque * -nb1 * inv2;       // dE/db2 = c2 n2
  const float d1a = torque * dot(b0, b1) * invb * inv1;
  const float d1b = torque * dot(b2, b1) * invb * inv2;
  e3 = {c0 * n1.x, c0 * n1.y, c0 * n1.z};
  e4 = {d1a * n1.x + d1b * n2.x, d1a * n1.y + d1b * n2.y,
        d1a * n1.z + d1b * n2.z};
  e5 = {c2 * n2.x, c2 * n2.y, c2 * n2.z};
  return qk * (1.0f + cosf(arg));
}

// The edge gradient in flat slot f = role * W + w (recomputes its term).
template <bool kBias>
__device__ __forceinline__ V3 edge_of_slot(const float* P,
                                           const BondedTables& t, int f,
                                           int W, const float* bias_row) {
  const int role = f / W, w = f - role * W;
  V3 a, b, c;
  if (role == 0) {
    bond_term(P, t, w, a);
    return a;
  }
  if (role <= 2) {
    angle_term(P, t, w, a, b);
    return role == 1 ? a : b;
  }
  torsion_term<kBias>(P, t, w, bias_row, a, b, c);
  return role == 3 ? a : (role == 4 ? b : c);
}

// Nonbonded sums of one atom over all j: LJ and electrostatic force rows
// (the electrostatic term without the salt scale) and, with kEnergy, the
// two pair-energy sums (each pair counted from both sides).
struct PairAcc {
  float flx = 0.f, fly = 0.f, flz = 0.f;
  float fex = 0.f, fey = 0.f, fez = 0.f;
  float e_lj = 0.f, e_el = 0.f;
};

// One pair's terms added to atom i's sums: LJ from the mixed sigma and
// eps = sqrt(eps_i) sqrt(eps_j), bare Coulomb from qq = q_i q_j, all times
// the 0/1 pair mask m.  r2 arrives already guarded (r2 += 1 - m), so a
// masked pair stays finite and adds exactly zero.  The body of
// lj_forces/kernel.py nonbonded_pair_rows and of the sparse kernel's slot.
template <bool kEnergy>
__device__ __forceinline__ void pair_accumulate(float dx, float dy, float dz,
                                                float r2, float m, float sig,
                                                float eps, float qq,
                                                float coulomb, PairAcc& acc) {
  const float tt = sig * sig / r2;
  const float s6 = tt * (tt * tt);
  const float rr = sqrtf(r2);
  if (kEnergy) {
    acc.e_lj += 4.0f * eps * (s6 * s6 - s6) * m;
    acc.e_el += coulomb * qq / rr * m;
  }
  const float c_lj = 24.0f * eps * (2.0f * s6 * s6 - s6) / r2 * m;
  const float c_el = coulomb * qq / (r2 * rr) * m;
  acc.flx += c_lj * dx;
  acc.fly += c_lj * dy;
  acc.flz += c_lj * dz;
  acc.fex += c_el * dx;
  acc.fey += c_el * dy;
  acc.fez += c_el * dz;
}

// Sum of v over a block of kTile threads in a fixed tree order (every
// thread gets the sum; sh holds kTile floats).  No atomics, so the energy
// sums of the nonbonded kernels are bitwise reproducible.
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

// e[r] = 0.5 * the sum over tiles, in order, of an (R, n_tiles, 2) scratch
// of per-block (LJ, elec) sums (one thread per replica).
__global__ void tile_energy_kernel(const float* __restrict__ e_part,
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

}  // namespace md
