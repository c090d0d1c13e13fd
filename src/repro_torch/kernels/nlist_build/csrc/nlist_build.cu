// Device-gated neighbor-list build for a replica stack, written for Hopper
// (sm_90a): the masked build of src/repro/md/neighbors.py build_dense
// (:95), run only where a device flag asks for it, testing only the atom
// tiles that can hold a neighbor.
//
// Not a TPU kernel: the JAX package builds the list with jnp under
// lax.cond(jnp.any(need), rebuild, keep) (neighbors.py:346), evaluated
// before every force evaluation.  These kernels are the port's form of
// that cond.  needs_rebuild stays plain PyTorch and leaves a device flag;
// the kernels read it per replica (flag[r * flag_stride]: stride 0 for the
// one element of the sync policy, 1 for the lazy policy's (R,) row) and
//   flag 0: copy the replica's old idx / valid rows to the outputs;
//   flag 1: build the replica's list.
// So the host never reads the flag (run_fused's no-sync contract holds), and
// a step without drift pays a copy of the list, not a build.  The outputs
// are fresh buffers (out of place): the failure-recovery backup holds
// references to the previous state's tensors.
//
// The list's contract (build_dense, _pack_rows): row i holds the first K
// columns j, in ascending order, with r2(i, j) <= r_list^2 and an unexcluded
// (i, j) (the pack's mask bits: 0 on the diagonal and on 1-2 / 1-3 pairs),
// padded with idx = N, valid = 0; dropped[r] = sum over rows of
// max(count - K, 0).  r2 = dx*dx + dy*dy + dz*dz is formed without FMA
// contraction (__fmul_rn / __fadd_rn), as PyTorch's separate elementwise ops
// form it, so the kernels equal their plain version bit for bit.
//
// What bounds it on an H100: bytes.  A rebuild reads the positions and
// writes the (R, N, K) list (int32 idx, float32 valid): 146 MB at R = 384,
// N = 2881, K = 15, 0.044 ms at 3.35 TB/s.  The distance tests it needs are
// those of the pairs that can be neighbors; an earlier design, one warp
// per row scanning all N^2 pairs, took 5.24 ms there on an H100 80GB HBM3
// at 700 W.  A kept list is a copy of 266 MB, 0.079 ms.
//
// Design: two launches per call.
//   nlist_prep_kernel, grid (G, R): for a replica with flag 1, one warp per
//     32-atom tile writes the tile's bounding box (min x, y, z, max x, y, z
//     over its real atoms) to an (R, ceil(N / 32), 6) scratch; for a
//     replica with flag 0, the G blocks copy its contiguous N K words of
//     idx and of valid with 16-byte loads and stores between a scalar head
//     (to the 16-byte boundary) and a scalar tail.  Block 0 zeroes
//     dropped[r].
//   nlist_build_kernel, grid (ceil(n_t / 4), R), 4 warps: one warp per
//     32-row i-tile I, lane l owning row i = 32 I + l.  The lanes test the
//     j-tiles' boxes against I's box 32 at a time; the candidate tiles come
//     out of the ballot in ascending order.  Each candidate tile's positions
//     are staged in the warp's shared memory as x, y, z rows, and each lane
//     walks the tile's 32 atoms in ascending j, reading the mask as one
//     32-bit word of its row (mask_bits[i, J]), placing hits past its count
//     and only counting those past slot K - 1.  The 32 rows' slots are
//     collected in shared memory and written out as one contiguous run of
//     32 K words (rows 32 I .. 32 I + 31 are adjacent in (R, N, K)), valid
//     derived from idx < N.  dropped is summed with one integer atomic per
//     warp (an integer sum does not depend on order).
//
// Why the cull never drops a neighbor.  For i in tile I and j in tile J,
// the exact |x_i - x_j| >= max(lo_J - hi_I, lo_I - hi_J, 0), and rounding
// to nearest is monotone, so the computed |dx| = fl(|x_i - x_j|) >=
// fl(lo_J - hi_I), fl(lo_I - hi_J) and 0, whose maximum is the computed
// gap gx.  Squares and sums of nonnegative floats rounded to nearest are
// monotone too, so the computed r2 (unfused, in the same order) >= the
// computed g2 = (gx^2 + gy^2) + gz^2.  A tile pair is skipped only where
// g2 > r_list^2 (1 + 2^-16); then every r2 > r_list^2 and no pair of it is
// a neighbor.  The margin is not needed by that argument; it covers the
// argument's premises (a contraction or a reassociation of the box sums
// changes g2 by a few ulp, 2^-22 relative at most, far inside 2^-16).
// Nothing depends on the chain's layout: a random gas gets the same lists,
// only with more candidate tiles.  NaN positions: a box is min/max over
// the non-NaN atoms, and a NaN pair is never a neighbor on either side.
#include <cuda_runtime.h>
#include <stdint.h>

#include "nlist_common.cuh"

namespace {

constexpr int kT = 32;              // atoms per tile: one word of mask bits
constexpr int kPrepThreads = 256;
constexpr int kBuildWarps = 4;      // i-tiles per block of the build
constexpr int kMaxSmem = 232448;    // shared memory one block may use

__global__ void __launch_bounds__(kPrepThreads) nlist_prep_kernel(
    const float* __restrict__ pos, const int* __restrict__ flag,
    int flag_stride, const int* __restrict__ old_idx,
    const float* __restrict__ old_valid, int* __restrict__ idx,
    float* __restrict__ valid, float* __restrict__ boxes,
    int* __restrict__ dropped, int N, int K) {
  const int r = blockIdx.y;
  if (blockIdx.x == 0 && threadIdx.x == 0) dropped[r] = 0;
  if (flag[(size_t)r * flag_stride] != 0) {
    const int n_t = (N + kT - 1) / kT;
    const int lane = threadIdx.x % 32;
    const int t = blockIdx.x * (kPrepThreads / 32) + threadIdx.x / 32;
    if (t >= n_t) return;                   // whole warps leave together
    const int j = kT * t + lane;
    const float* P = pos + (size_t)r * N * 3;
    float lo[3], hi[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      lo[c] = j < N ? P[3 * j + c] : __int_as_float(0x7f800000);    // +inf
      hi[c] = j < N ? P[3 * j + c] : __int_as_float(0xff800000);    // -inf
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        lo[c] = fminf(lo[c], __shfl_xor_sync(0xffffffffu, lo[c], o));
        hi[c] = fmaxf(hi[c], __shfl_xor_sync(0xffffffffu, hi[c], o));
      }
    }
    const float v = lane == 0   ? lo[0]
                    : lane == 1 ? lo[1]
                    : lane == 2 ? lo[2]
                    : lane == 3 ? hi[0]
                    : lane == 4 ? hi[1]
                                : hi[2];
    if (lane < 6) boxes[((size_t)r * n_t + t) * 6 + lane] = v;
    return;
  }
  const size_t nk = (size_t)N * K, base = (size_t)r * nk;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  copy_words(reinterpret_cast<const uint32_t*>(old_idx) + base,
             reinterpret_cast<uint32_t*>(idx) + base, nk, tid, stride);
  copy_words(reinterpret_cast<const uint32_t*>(old_valid) + base,
             reinterpret_cast<uint32_t*>(valid) + base, nk, tid, stride);
}

// Per-axis gap of two boxes (lo x, y, z, hi x, y, z), 0 where they overlap.
__device__ __forceinline__ float gap(const float* a, const float* b, int c) {
  return fmaxf(fmaxf(__fsub_rn(b[c], a[3 + c]), __fsub_rn(a[c], b[3 + c])),
               0.f);
}

__global__ void __launch_bounds__(32 * kBuildWarps) nlist_build_kernel(
    const float* __restrict__ pos, const uint32_t* __restrict__ bits, int nw,
    const float* __restrict__ boxes, const int* __restrict__ flag,
    int flag_stride, int* __restrict__ idx, float* __restrict__ valid,
    int* __restrict__ dropped, int N, int K, float r_list2, float cull2) {
  extern __shared__ float smem[];
  const int r = blockIdx.y;
  if (flag[(size_t)r * flag_stride] == 0) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_t = (N + kT - 1) / kT;
  const int I = blockIdx.x * kBuildWarps + warp;
  if (I >= n_t) return;                     // whole warps; no block barrier
  float* sx = smem + (size_t)warp * (3 * kT + kT * K);
  float* sy = sx + kT;
  float* sz = sy + kT;
  int* slots = reinterpret_cast<int*>(sz + kT);   // (32, K) of this tile
  const float* P = pos + (size_t)r * N * 3;
  const float* B = boxes + (size_t)r * n_t * 6;
  float bi[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) bi[c] = B[6 * I + c];
  const int i = kT * I + lane;
  const bool live = i < N;
  const float xi = live ? P[3 * i] : 0.f, yi = live ? P[3 * i + 1] : 0.f,
              zi = live ? P[3 * i + 2] : 0.f;
  const uint32_t* mrow = bits + (size_t)(live ? i : 0) * nw;
  int count = 0;
  for (int w0 = 0; w0 < n_t; w0 += 32) {
    const int t = w0 + lane;
    bool near = false;
    if (t < n_t) {
      const float* bj = B + 6 * t;
      near = !(r2_unfused(gap(bi, bj, 0), gap(bi, bj, 1), gap(bi, bj, 2)) >
               cull2);
    }
    uint32_t cand = __ballot_sync(0xffffffffu, near);
    while (cand != 0u) {                     // ascending tiles
      const int J = w0 + __ffs(cand) - 1;
      cand &= cand - 1u;
      const int j = kT * J + lane;
      __syncwarp();
      sx[lane] = j < N ? P[3 * j] : 0.f;
      sy[lane] = j < N ? P[3 * j + 1] : 0.f;
      sz[lane] = j < N ? P[3 * j + 2] : 0.f;
      __syncwarp();
      const uint32_t word = live ? mrow[J] : 0u;   // bits of j >= N are 0
#pragma unroll 4
      for (int jj = 0; jj < kT; ++jj) {      // ascending j
        if ((word >> jj) & 1u) {
          const float r2 = r2_unfused(xi - sx[jj], yi - sy[jj], zi - sz[jj]);
          if (r2 <= r_list2) {
            if (count < K) slots[lane * K + count] = kT * J + jj;
            ++count;
          }
        }
      }
    }
  }
  for (int k = count; k < K; ++k) slots[lane * K + k] = N;
  __syncwarp();
  const int n_rows = min(kT, N - kT * I);
  const size_t base = ((size_t)r * N + (size_t)kT * I) * K;
  for (int e = lane; e < n_rows * K; e += 32) {
    const int v = slots[e];
    idx[base + e] = v;
    valid[base + e] = v < N ? 1.0f : 0.0f;
  }
  int over = count > K ? count - K : 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    over += __shfl_xor_sync(0xffffffffu, over, o);
  if (lane == 0 && over > 0) atomicAdd(dropped + r, over);
}

// Shared memory of the build for a k_max of K (0 if over the limit).
int build_smem_bytes(int K) {
  const long bytes = (long)kBuildWarps * (3 * kT + kT * (long)K) * 4;
  return bytes <= kMaxSmem ? static_cast<int>(bytes) : 0;
}

}  // namespace

// bits: the pack's (ld, nw) mask bits; boxes: an (R, ceil(N / 32), 6)
// scratch; cull2: r_list2 (1 + 2^-16) as float32.
extern "C" int nlist_build_launch(const float* pos, const uint32_t* bits,
                                  int nw, const int* flag, int flag_stride,
                                  const int* old_idx, const float* old_valid,
                                  int* idx, float* valid, float* boxes,
                                  int* dropped, int R, int N, int K,
                                  float r_list2, float cull2, void* stream) {
  if (R == 0 || N == 0) return 0;
  const int n_t = (N + kT - 1) / kT;
  const int smem = build_smem_bytes(K);
  if (K < 1 || nw < n_t || smem == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // The shared-memory opt-in holds for the current device only: set it on
  // a device's first call, before any graph capture on it.
  constexpr int kMaxDevices = 64;
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !attr_set[dev]) {
    err = cudaFuncSetAttribute(nlist_build_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) attr_set[dev] = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t words = (size_t)N * K;
  const int box_blocks = (n_t + kPrepThreads / 32 - 1) / (kPrepThreads / 32);
  const size_t copy_blocks = (words / 4 + kPrepThreads - 1) / kPrepThreads;
  const int g = static_cast<int>(
      copy_blocks > (size_t)box_blocks ? copy_blocks : box_blocks);
  nlist_prep_kernel<<<dim3(g, R), kPrepThreads, 0, st>>>(
      pos, flag, flag_stride, old_idx, old_valid, idx, valid, boxes, dropped,
      N, K);
  nlist_build_kernel<<<dim3((n_t + kBuildWarps - 1) / kBuildWarps, R),
                       32 * kBuildWarps, smem, st>>>(
      pos, bits, nw, boxes, flag, flag_stride, idx, valid, dropped, N, K,
      r_list2, cull2);
  return static_cast<int>(cudaGetLastError());
}
