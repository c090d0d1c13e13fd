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
// What bounds it on an H100: the launch.  It reads 4 R + 6 C floats and
// writes R C floats (590 KB at R = C = 384, 0.18 us at 3.35 TB/s) and does
// about 25 operations per element (3.7 Mflop, 0.06 us at 67 TFLOP/s); an
// empty kernel on its grid takes 1.7-1.8 us of device time, one block of
// 32 threads 1.3-1.4 (PERF.md section 6).
//
// Design: one thread per element, grid (C-blocks of 128, R), so a warp
// writes 32 neighbouring floats of one row and reads that row's four
// features once (broadcast).  It sits a load round trip and its
// arithmetic above the empty kernel on its grid.  A grid sized to the
// work, exchange_matrix_staged_kernel below (at most one block per SM,
// the (6, C) control rows staged in shared memory once a block, each
// thread four neighbouring elements and one 16-byte store, a block
// several rows), is slower on an H100: its loads, barrier and
// shared-memory reads come before the first store, and a quarter of the
// threads each run four elements' chains (PERF.md section 6).
// It is on no path and is kept to time beside this kernel.  Inputs are
// packed feature rows (4, R): u_base, u_elec, phi_deg, psi_deg, and ctrl
// rows (6, C): beta, salt, c0, c1, k0, k1 (exchange_matrix/ops.py).  The
// library is built with -fmad=false, so nothing is contracted into an FMA
// and the result equals the plain version (ref.exchange_matrix) on the
// card bit for bit.
#include <cuda_runtime.h>

#include <algorithm>

#include "md_terms.cuh"

namespace {

constexpr int kSms = 132;          // blocks of the staged design at most
constexpr int kMaxStagedC = 2048;  // its (6, C) rows in 48 KB of shared

__device__ __forceinline__ float element(float u_base, float u_elec,
                                         float phi, float psi,
                                         const float* __restrict__ ctrl,
                                         int C, int c) {
  const float beta = ctrl[c], salt = ctrl[C + c];
  const float c0 = ctrl[2 * C + c], c1 = ctrl[3 * C + c];
  const float k0 = ctrl[4 * C + c], k1 = ctrl[5 * C + c];
  float u = u_base + (1.0f - 0.5f * salt) * u_elec;
  const float d0 = md::wrap_deg(phi - c0);
  const float d1 = md::wrap_deg(psi - c1);
  u = u + k0 * d0 * d0;
  u = u + k1 * d1 * d1;
  return beta * u;
}

__global__ void exchange_matrix_kernel(const float* __restrict__ feat,
                                       const float* __restrict__ ctrl,
                                       float* __restrict__ out, int R,
                                       int C) {
  const int i = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  out[(size_t)i * C + c] = element(feat[i], feat[R + i], feat[2 * R + i],
                                   feat[3 * R + i], ctrl, C, c);
}

// Block (T, Y): row blockIdx.x Y + threadIdx.y, then + gridDim.x Y, ...;
// thread x the columns 4 x .. 4 x + 3 (and 4 x + 4 T, ...), one float4
// store where C % 4 == 0 (every row 16-byte aligned), else scalar stores.
__global__ void exchange_matrix_staged_kernel(const float* __restrict__ feat,
                                              const float* __restrict__ ctrl,
                                              float* __restrict__ out, int R,
                                              int C) {
  extern __shared__ float rows[];  // (6, C)
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  for (int k = t; k < 6 * C; k += blockDim.x * blockDim.y) rows[k] = ctrl[k];
  __syncthreads();
  for (int i = blockIdx.x * blockDim.y + threadIdx.y; i < R;
       i += gridDim.x * blockDim.y) {
    const float u_base = feat[i], u_elec = feat[R + i];
    const float phi = feat[2 * R + i], psi = feat[3 * R + i];
    float* row = out + (size_t)i * C;
    for (int c = 4 * threadIdx.x; c < C; c += 4 * blockDim.x) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = c + u < C ? element(u_base, u_elec, phi, psi, rows, C, c + u)
                         : 0.0f;
      if (C % 4 == 0) {
        *reinterpret_cast<float4*>(row + c) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
        for (int u = 0; u < 4 && c + u < C; ++u) row[c + u] = v[u];
      }
    }
  }
}

// T threads a row (C / 4, in warps, at most 1024), Y rows a block (enough
// for kSms blocks to hold every row, at most 1024 / T), at most kSms
// blocks.
dim3 staged_block(int R, int C) {
  const int t = std::min(((C + 3) / 4 + 31) / 32 * 32, 1024);
  const int y = std::max(1, std::min((R + kSms - 1) / kSms, 1024 / t));
  return dim3(t, y);
}

int staged_blocks(int R, int C) {
  const int y = staged_block(R, C).y;
  return std::min((R + y - 1) / y, kSms);
}

// The launch floors: an empty kernel, timed beside the kernel to show what
// a launch costs the device by itself.  On no path.
__global__ void empty_kernel() {}

}  // namespace

extern "C" int exchange_matrix_launch(const float* feat, const float* ctrl,
                                      float* out, int R, int C,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  exchange_matrix_kernel<<<dim3((C + 127) / 128, R), 128, 0, st>>>(
      feat, ctrl, out, R, C);
  return static_cast<int>(cudaGetLastError());
}

// The staged design, on no path: timed beside the kernel.
extern "C" int exchange_matrix_staged_launch(const float* feat,
                                             const float* ctrl, float* out,
                                             int R, int C, void* stream) {
  if (R == 0 || C == 0) return 0;
  if (C > kMaxStagedC) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  exchange_matrix_staged_kernel<<<staged_blocks(R, C), staged_block(R, C),
                                  6 * C * sizeof(float), st>>>(feat, ctrl,
                                                               out, R, C);
  return static_cast<int>(cudaGetLastError());
}

// grid: 0 the kernel's, (C / 128, R) blocks of 128; 1 the staged
// design's; 2 one block of 32 threads, the least any launch costs.
extern "C" int empty_launch(int R, int C, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (grid == 0)
    empty_kernel<<<dim3((C + 127) / 128, R), 128, 0, st>>>();
  else if (grid == 1)
    empty_kernel<<<staged_blocks(R, C), staged_block(R, C), 0, st>>>();
  else
    empty_kernel<<<1, 32, 0, st>>>();
  return static_cast<int>(cudaGetLastError());
}
