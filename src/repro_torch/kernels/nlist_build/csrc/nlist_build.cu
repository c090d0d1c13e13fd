// Device-gated neighbor-list build for a replica stack, written for Hopper
// (sm_90a): the masked O(N^2) build of src/repro/md/neighbors.py build_dense
// (:95), run only where a device flag asks for it.
//
// Not a TPU kernel: the JAX package builds the list with jnp under
// lax.cond(jnp.any(need), rebuild, keep) (neighbors.py:346), evaluated
// before every force evaluation.  This kernel is the port's form of that
// cond.  needs_rebuild stays plain PyTorch and leaves a device flag; the
// kernel reads it per replica (flag[r * flag_stride]: stride 0 for the one
// element of the sync policy, 1 for the lazy policy's (R,) row) and
//   flag 0: copies the replica's old idx / valid rows to the outputs;
//   flag 1: builds the replica's list.
// So the host never reads the flag (run_fused's no-sync contract holds), and
// a step without drift pays a copy of the list, not an O(R N^2) build.  The
// outputs are fresh buffers (out of place): the failure-recovery backup
// holds references to the previous state's tensors.
//
// The list's contract (build_dense, _pack_rows): row i holds the first K
// columns j, in ascending order, with r2(i, j) <= r_list^2 and an unexcluded
// (i, j) (the uint8 mask row, 0 on the diagonal and on 1-2 / 1-3 pairs),
// padded with idx = N, valid = 0; dropped[r] = sum over rows of
// max(count - K, 0).  r2 = dx*dx + dy*dy + dz*dz is formed without FMA
// contraction (__fmul_rn / __fadd_rn), as PyTorch's separate elementwise ops
// form it, so the kernel equals its plain version bit for bit.
//
// Design: one warp per (replica, atom row i).  The warp scans j in ascending
// chunks of 32, one candidate per lane; __ballot_sync marks the chunk's hits,
// the popcount of the hits below a lane places it after the row's running
// count, and hits past slot K - 1 are only counted.  The replica's positions
// and the mask rows are read from L1/L2.  dropped is summed with integer
// atomics (an integer sum does not depend on order); it is zeroed first, and
// stays 0 for a replica whose flag is 0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // rows per block

__global__ void __launch_bounds__(32 * kWarps) nlist_build_kernel(
    const float* __restrict__ pos, const uint8_t* __restrict__ mask, int ld,
    const int* __restrict__ flag, int flag_stride,
    const int* __restrict__ old_idx, const float* __restrict__ old_valid,
    int* __restrict__ idx, float* __restrict__ valid,
    int* __restrict__ dropped, int N, int K, float r_list2) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.y;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= N) return;                       // whole warps leave together
  const size_t row = ((size_t)r * N + i) * K;
  if (flag[(size_t)r * flag_stride] == 0) {
    for (int k = lane; k < K; k += 32) {
      idx[row + k] = old_idx[row + k];
      valid[row + k] = old_valid[row + k];
    }
    return;
  }
  const float* P = pos + (size_t)r * N * 3;
  const float xi = P[3 * i], yi = P[3 * i + 1], zi = P[3 * i + 2];
  const uint8_t* mrow = mask + (size_t)i * ld;
  const unsigned below = (1u << lane) - 1u;
  int count = 0;
  for (int j0 = 0; j0 < N; j0 += 32) {
    const int j = j0 + lane;
    bool hit = false;
    if (j < N && mrow[j] != 0) {
      const float dx = xi - P[3 * j], dy = yi - P[3 * j + 1],
                  dz = zi - P[3 * j + 2];
      const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                           __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      hit = r2 <= r_list2;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    const int slot = count + __popc(ballot & below);
    if (hit && slot < K) {
      idx[row + slot] = j;
      valid[row + slot] = 1.0f;
    }
    count += __popc(ballot);
  }
  for (int k = count + lane; k < K; k += 32) {
    idx[row + k] = N;
    valid[row + k] = 0.0f;
  }
  if (lane == 0 && count > K) atomicAdd(dropped + r, count - K);
}

}  // namespace

extern "C" int nlist_build_launch(const float* pos, const uint8_t* mask,
                                  int ld, const int* flag, int flag_stride,
                                  const int* old_idx, const float* old_valid,
                                  int* idx, float* valid, int* dropped, int R,
                                  int N, int K, float r_list2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(dropped, 0, sizeof(int) * R, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  nlist_build_kernel<<<dim3((N + kWarps - 1) / kWarps, R), 32 * kWarps, 0,
                       st>>>(pos, mask, ld, flag, flag_stride, old_idx,
                             old_valid, idx, valid, dropped, N, K, r_list2);
  return static_cast<int>(cudaGetLastError());
}
