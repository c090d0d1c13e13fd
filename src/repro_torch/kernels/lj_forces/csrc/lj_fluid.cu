// Lennard-Jones fluid of a replica stack, written for Hopper (sm_90a): the
// total energy per replica and the forces, uniform sigma and eps, every
// ordered pair under the minimum-image periodic box.
//
// Replaces: src/repro/kernels/lj_forces/kernel.py
//   lj_energy_kernel_batched (pl.pallas_call at :104, body
//   _energy_kernel_batched at :59) and lj_forces_kernel_batched
//   (pl.pallas_call at :126, body _forces_kernel_batched at :74), both
//   through the tile _pair_blocks at :32.
//
// What bounds them on an H100: operations.  At R = 64, N = 864 the
// function needs each of 2.4e7 unordered pairs once; these kernels, like
// the TPU bodies, evaluate all 4.8e7 ordered pairs, each with four IEEE
// divisions (three for the minimum image, one for sigma^2 / r^2, plus
// one more in the force coefficient).  The bytes are positions in and
// forces out, 1.3 MB.
//
// Design: one block per (i-block of 128 atoms, replica); each thread owns
// one atom i and walks the j-tiles in ascending order, the tile's x, y, z
// staged in shared memory, its force or energy sum in registers.  The
// minimum image is d - box * rint(d / box): rintf rounds half to even as
// jnp.round does, and the division stays IEEE (no --use_fast_math).  The
// diagonal gets r2 += 1 - m with m = 0, as _pair_blocks masks it, so it
// stays finite and contributes exactly zero; the port's (R, N, 3) layout
// has no padding atoms, so the tile loop simply stops at N.  Energies:
// each block reduces its threads' sums in md::block_sum's fixed tree
// order into an (R, n_blocks) scratch, a second kernel sums the blocks in
// order and halves.  No atomics: bitwise reproducible.  The constants
// sigma^2, 4 eps, 24 eps and box arrive as the float32 values JAX forms
// (lj_forces/ref.py::fluid_constants).  Speed work (each unordered pair
// once, reciprocals, a cell list) is for later.
#include <cuda_runtime.h>

#include "md_terms.cuh"

namespace {

using md::kTile;

struct FluidConsts {
  float box, sig2, c4, c24;
};

// jnp.round(d / box) is half to even: rintf.
__device__ __forceinline__ float min_image(float d, float box) {
  return box > 0.f ? d - box * rintf(d / box) : d;
}

template <bool kForces>
__global__ void __launch_bounds__(kTile) lj_fluid_kernel(
    const float* __restrict__ pos, float* __restrict__ out, int N,
    FluidConsts c) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile];
  __shared__ float red[kTile];
  const int r = blockIdx.y, tid = threadIdx.x;
  const int i = blockIdx.x * kTile + tid;
  const bool live = i < N;
  const float* P = pos + (size_t)r * N * 3;
  md::V3 pi = {0.f, 0.f, 0.f};
  if (live) pi = md::load3(P, i);
  float fx = 0.f, fy = 0.f, fz = 0.f, e = 0.f;
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
      const float dx = min_image(pi.x - sx[jj], c.box);
      const float dy = min_image(pi.y - sy[jj], c.box);
      const float dz = min_image(pi.z - sz[jj], c.box);
      const float r2 = dx * dx + dy * dy + dz * dz + (1.f - m);
      const float t = c.sig2 / r2;
      const float s6 = t * (t * t);
      if (kForces) {
        const float coef = c.c24 * (2.f * s6 * s6 - s6) / r2 * m;
        fx += coef * dx;
        fy += coef * dy;
        fz += coef * dz;
      } else {
        e += c.c4 * (s6 * s6 - s6) * m;
      }
    }
  }
  if (kForces) {
    if (live) {
      float* F = out + ((size_t)r * N + i) * 3;
      F[0] = fx;
      F[1] = fy;
      F[2] = fz;
    }
  } else {
    const float b = md::block_sum(e, red);
    if (tid == 0) out[(size_t)r * gridDim.x + blockIdx.x] = b;
  }
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

}  // namespace

extern "C" int lj_energy_launch(const float* pos, float* e_part,
                                float* energy, int R, int N, float box,
                                float sig2, float c4, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_blocks = (N + kTile - 1) / kTile;
  lj_fluid_kernel<false><<<dim3(n_blocks, R), kTile, 0, st>>>(
      pos, e_part, N, FluidConsts{box, sig2, c4, 0.f});
  block_energy_kernel<<<(R + 127) / 128, 128, 0, st>>>(e_part, energy, R,
                                                       n_blocks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lj_forces_launch(const float* pos, float* forces, int R,
                                int N, float box, float sig2, float c24,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_blocks = (N + kTile - 1) / kTile;
  lj_fluid_kernel<true><<<dim3(n_blocks, R), kTile, 0, st>>>(
      pos, forces, N, FluidConsts{box, sig2, 0.f, c24});
  return static_cast<int>(cudaGetLastError());
}
