// Bonded forces (harmonic bonds, harmonic angles, cosine torsions) and the
// total bonded energy for a replica stack, written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/chain_forces/kernel.py
//   chain_forces_kernel_batched (pl.pallas_call at :199, body
//   bonded_scatter_rows at :71), bias=False variant.  The umbrella-bias
//   torque comes with the umbrella ladders.
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
//     interior mask, atan2 dihedral) and writes them to an (R, 6W, 3)
//     scratch (13 MB at R = 64, resident in the 50 MB L2), plus its term
//     energy to an (R, 3, W) scratch.
//   Phase 2 (bonded_gather_kernel): one thread per (replica, atom) sums the
//     <= S signed edge slots of bonded_slots in slot order.
//   Energy (bonded_energy_kernel): one block per replica reduces each term
//     class in a fixed tree order.
// There are no float atomics, so results are bitwise identical run to run
// (what keeps run_fused's decisions independent of the chunk size).
#include <cuda_runtime.h>

namespace {

constexpr float kClipLo = (float)(-1.0 + 1e-6);
constexpr float kClipHi = (float)(1.0 - 1e-6);

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
__device__ __forceinline__ void store3(float* e, int slot, V3 v) {
  e[3 * slot] = v.x;
  e[3 * slot + 1] = v.y;
  e[3 * slot + 2] = v.z;
}

// Edge slot ``role * W + w``: role 0 bond d, 1 angle v1 arm, 2 angle v2 arm,
// 3 torsion b0, 4 torsion b1, 5 torsion b2 (the layout of bonded_slots).
__global__ void bonded_edges_kernel(
    const float* __restrict__ pos, const int* __restrict__ bonds,
    const float* __restrict__ bond_par, const int* __restrict__ angles,
    const float* __restrict__ ang_par, const int* __restrict__ quads,
    const float* __restrict__ quad_par, float* __restrict__ edges,
    float* __restrict__ term_e, int N, int B, int A, int Q, int W) {
  const int r = blockIdx.y;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B + A + Q) return;
  const float* P = pos + (size_t)r * N * 3;
  float* E = edges + (size_t)r * 6 * W * 3;
  float* TE = term_e + (size_t)r * 3 * W;

  if (t < B) {                                   // bond: E = k (r - r0)^2
    const int w = t;
    const V3 pi = load3(P, bonds[2 * w]), pj = load3(P, bonds[2 * w + 1]);
    const V3 d = {pi.x - pj.x + 1e-12f, pi.y - pj.y + 1e-12f,
                  pi.z - pj.z + 1e-12f};
    const float rr = sqrtf(dot(d, d));
    const float r0 = bond_par[w], k = bond_par[B + w];
    const float dr = rr - r0;
    TE[w] = k * (dr * dr);
    const float cb = 2.0f * k * dr / rr;
    store3(E, w, {cb * d.x, cb * d.y, cb * d.z});
  } else if (t < B + A) {                        // angle: k (theta - t0)^2
    const int w = t - B;
    const V3 pb = load3(P, angles[3 * w + 1]);
    const V3 v1 = sub(load3(P, angles[3 * w]), pb);
    const V3 v2 = sub(load3(P, angles[3 * w + 2]), pb);
    const float n1 = sqrtf(dot(v1, v1)), n2 = sqrtf(dot(v2, v2));
    const float den = n1 * n2 + 1e-9f;
    const float d12 = dot(v1, v2);
    const float cosv = d12 / den;
    const float cc = fminf(fmaxf(cosv, kClipLo), kClipHi);
    const float theta = acosf(cc);
    const float t0 = ang_par[w], k = ang_par[A + w];
    const float dth = theta - t0;
    TE[W + w] = k * (dth * dth);
    const float interior = (cosv > kClipLo && cosv < kClipHi) ? 1.0f : 0.0f;
    const float g_c =
        2.0f * k * dth * (-1.0f / sqrtf(1.0f - cc * cc)) * interior;
    const float w1 = d12 * n2 / (den * den * (n1 + 1e-12f));
    const float w2 = d12 * n1 / (den * den * (n2 + 1e-12f));
    store3(E, W + w, {g_c * (v2.x / den - w1 * v1.x),
                      g_c * (v2.y / den - w1 * v1.y),
                      g_c * (v2.z / den - w1 * v1.z)});
    store3(E, 2 * W + w, {g_c * (v1.x / den - w2 * v2.x),
                          g_c * (v1.y / den - w2 * v2.y),
                          g_c * (v1.z / den - w2 * v2.z)});
  } else {                                       // torsion: k (1 + cos(n phi - ph))
    const int w = t - B - A;
    const int* q = quads + 4 * w;
    const V3 p0 = load3(P, q[0]), p1 = load3(P, q[1]);
    const V3 p2 = load3(P, q[2]), p3 = load3(P, q[3]);
    const V3 b0 = sub(p1, p0), b1 = sub(p2, p1), b2 = sub(p3, p2);
    const V3 n1 = cross(b0, b1), n2 = cross(b1, b2);
    const float nb1 = sqrtf(dot(b1, b1));
    const float g = nb1 + 1e-9f;
    const V3 m1 = cross(n1, {b1.x / g, b1.y / g, b1.z / g});
    const float phi = atan2f(dot(m1, n2), dot(n1, n2));
    const float qn = quad_par[w], qk = quad_par[Q + w];
    const float arg = qn * phi - quad_par[2 * Q + w];
    TE[2 * W + w] = qk * (1.0f + cosf(arg));
    const float torque = -qk * qn * sinf(arg);
    const float inv1 = 1.0f / (dot(n1, n1) + 1e-12f);
    const float inv2 = 1.0f / (dot(n2, n2) + 1e-12f);
    const float invb = 1.0f / (nb1 + 1e-12f);
    const float c0 = torque * -nb1 * inv1;       // dE/db0 = c0 n1
    const float c2 = torque * -nb1 * inv2;       // dE/db2 = c2 n2
    const float d1a = torque * dot(b0, b1) * invb * inv1;
    const float d1b = torque * dot(b2, b1) * invb * inv2;
    store3(E, 3 * W + w, {c0 * n1.x, c0 * n1.y, c0 * n1.z});
    store3(E, 4 * W + w, {d1a * n1.x + d1b * n2.x, d1a * n1.y + d1b * n2.y,
                          d1a * n1.z + d1b * n2.z});
    store3(E, 5 * W + w, {c2 * n2.x, c2 * n2.y, c2 * n2.z});
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

extern "C" int chain_forces_launch(
    const float* pos, const int* bonds, const float* bond_par,
    const int* angles, const float* ang_par, const int* quads,
    const float* quad_par, const int* slot_idx, const float* slot_sign,
    float* edges, float* term_e, float* force, float* energy, int R, int N,
    int B, int A, int Q, int W, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = B + A + Q;
  bonded_edges_kernel<<<dim3((T + 127) / 128, R), 128, 0, st>>>(
      pos, bonds, bond_par, angles, ang_par, quads, quad_par, edges, term_e,
      N, B, A, Q, W);
  bonded_gather_kernel<<<dim3((N + 127) / 128, R), 128, 0, st>>>(
      edges, slot_idx, slot_sign, force, N, W, S);
  bonded_energy_kernel<<<R, kEnergyThreads, 0, st>>>(term_e, energy, B, A, Q,
                                                     W);
  return static_cast<int>(cudaGetLastError());
}
