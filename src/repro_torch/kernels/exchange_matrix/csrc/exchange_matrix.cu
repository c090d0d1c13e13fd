// The (R, C) replica x ctrl reduced-energy matrix of the Gibbs exchange,
// written for Hopper (sm_90a):
//   u[i, c] = beta_c * (u_base_i + (1 - salt_c / 2) * u_elec_i
//                       + k0_c * wrap(phi_i - c0_c)^2
//                       + k1_c * wrap(psi_i - c1_c)^2)
// with angles in degrees and wrap the floor-mod of jnp.mod.
//
// Replaces: src/repro/kernels/exchange_matrix/kernel.py
//   exchange_matrix_kernel (pl.pallas_call at :50, program _xmat_kernel).
//
// What bounds it on an H100: bytes, and below them the launch.  It reads
// 4 R + 6 C floats and writes R C floats (590 KB at R = C = 384, 0.18 us at
// 3.35 TB/s) and does about 25 operations per element (3.7 Mflop, 0.06 us at
// 67 TFLOP/s); a launch takes a few microseconds.
//
// Design: one thread per element, grid (C-blocks of 128, R), so a warp
// writes 32 neighbouring floats of one row and reads that row's four
// features once (broadcast).  Inputs are packed feature rows (4, R):
// u_base, u_elec, phi_deg, psi_deg, and ctrl rows (6, C): beta, salt, c0,
// c1, k0, k1 (exchange_matrix/ops.py).  The library is built with
// -fmad=false, so nothing is contracted into an FMA and the result equals
// the plain version (ref.exchange_matrix) on the card bit for bit.
#include <cuda_runtime.h>

#include "md_terms.cuh"

namespace {

__global__ void exchange_matrix_kernel(const float* __restrict__ feat,
                                       const float* __restrict__ ctrl,
                                       float* __restrict__ out, int R,
                                       int C) {
  const int i = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const float u_base = feat[i], u_elec = feat[R + i];
  const float phi = feat[2 * R + i], psi = feat[3 * R + i];
  const float beta = ctrl[c], salt = ctrl[C + c];
  const float c0 = ctrl[2 * C + c], c1 = ctrl[3 * C + c];
  const float k0 = ctrl[4 * C + c], k1 = ctrl[5 * C + c];
  float u = u_base + (1.0f - 0.5f * salt) * u_elec;
  const float d0 = md::wrap_deg(phi - c0);
  const float d1 = md::wrap_deg(psi - c1);
  u = u + k0 * d0 * d0;
  u = u + k1 * d1 * d1;
  out[(size_t)i * C + c] = beta * u;
}

}  // namespace

extern "C" int exchange_matrix_launch(const float* feat, const float* ctrl,
                                      float* out, int R, int C,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  exchange_matrix_kernel<<<dim3((C + 127) / 128, R), 128, 0, st>>>(
      feat, ctrl, out, R, C);
  return static_cast<int>(cudaGetLastError());
}
