// Device-gated cell-list build for a replica stack, written for Hopper
// (sm_90a): src/repro/md/neighbors.py build_cells (:204) with _cell_coords
// (:132), _bin_atoms (:152) and _cell_candidates (:175), run only where a
// device flag asks for it.
//
// As nlist_build.cu is for the dense build, this is the port's form of
// lax.cond(jnp.any(need), rebuild, keep) (neighbors.py:346) for
// method="cell": the kernels read the flag per replica (flag[r *
// flag_stride]: stride 0 for the sync policy's one element, 1 for the lazy
// policy's (R,) row) and
//   flag 0: copy the replica's old idx / valid rows to the outputs;
//   flag 1: build the replica's list.
// The host never reads the flag, and the outputs are fresh buffers.
//
// The list's contract (build_cells, _pack_rows): the cell width is
// max(r_list, (hi - lo) / G) per axis over the replica's bounding box, an
// atom's cell floor((p - lo) / width) clipped into the static grid; a
// cell's slots hold its atoms in ascending index (a stable sort), at most
// C of them (ranks past C are dropped and each counted once); row i holds
// the first K hits in candidate order -- stencil cell (x offsets outer, z
// inner; an axis of one cell has offset 0 only), then rank in the cell --
// where a hit is an atom with an unexcluded (i, j) (the pack's mask bits)
// and r2 <= r_list^2, padded with idx = N, valid = 0; dropped[r] = the
// capacity drops + sum over rows of max(count - K, 0).  Out-of-grid
// stencil cells gather padding in JAX; in-grid cells of distinct offsets
// are distinct, so JAX's dedupe of repeated cells never removes one here.
// Divisions are IEEE (__fdiv_rn) and r2 unfused, as PyTorch's separate
// ops form them: the kernels equal their plain version (ref.build_cells)
// bit for bit.
//
// Design: two launches per call.
//   cell_bin_kernel, grid (G, R), 1024 threads: for a replica with flag 0
//     the G blocks copy its N K words of idx and of valid; with flag 1,
//     block 0 alone bins the replica.  Its threads reduce the bounding box,
//     write each atom's cell to an (R, N) scratch and count the cells in
//     shared memory (an integer sum: order does not matter); warp 0 then
//     scans the counts into each cell's start and gives ranks by a
//     deterministic counting sort: it walks the atoms in ascending index,
//     32 at a time (the next 32 cells loaded while these are ranked), and
//     a lane's rank is its cell's running count plus the lanes below it in
//     the same cell (__match_any_sync); no atomic decides a rank.  Atom i
//     goes to an (R, N) order scratch at its cell's start + rank: the atoms
//     in cell order, each cell's first min(count, C) its kept slots.
//   cell_rows_kernel, grid (B, R), 4 warps: one warp per row, the rows
//     taken in cell order (neighbouring warps share candidate cells, which
//     stay in L1) and strided over the B blocks of a replica (B at most
//     ceil(N / 4) and about 16 blocks an SM over the stack, so a flag-0
//     replica costs a few empty blocks, not N / 4).  The warp walks the
//     row's in-grid stencil cells in order and each cell's kept atoms 32 at
//     a time, lane l testing the l-th; a ballot of the hits and the lanes
//     below give each hit its slot, so the row is written in rank order;
//     hits past K are only counted.  dropped gets an integer atomic per
//     row with an overflow.
// Shared memory: two ints per cell, so at most kMaxCells cells (16^3, the
// largest grid suggest_grid_dims gives).
//
// What bounds it on an H100: bytes, as the dense build (positions in, the
// (R, N, K) list and dropped out).  The candidates a row tests are its
// stencil cells' atoms; on the chain molecule (16 x 3 x 2 cells of ~180
// atoms) that is ~540 per row, which is why suggest_build_method keeps the
// chain on the dense build.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "nlist_common.cuh"

namespace {

constexpr int kBinThreads = 1024;
constexpr int kRowWarps = 4;        // warps (rows at a time) per block
constexpr int kRowBlocks = 132 * 16;  // row-pass blocks over the stack
constexpr int kMaxCells = 4096;

__global__ void __launch_bounds__(kBinThreads) cell_bin_kernel(
    const float* __restrict__ pos, const int* __restrict__ flag,
    int flag_stride, const int* __restrict__ old_idx,
    const float* __restrict__ old_valid, int* __restrict__ idx,
    float* __restrict__ valid, int* __restrict__ cell_of,
    int* __restrict__ order, int* __restrict__ start,
    int* __restrict__ kept, int* __restrict__ dropped, int N, int K, int gx,
    int gy, int gz, int cap, float r_list) {
  __shared__ int s_cnt[kMaxCells];   // counts, then each cell's start
  __shared__ int s_run[kMaxCells];   // ranks given so far
  __shared__ float s_red[6][32];
  __shared__ float s_box[6];
  const int r = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (flag[(size_t)r * flag_stride] == 0) {
    if (blockIdx.x == 0 && tid == 0) dropped[r] = 0;
    const size_t nk = (size_t)N * K, base = (size_t)r * nk;
    const size_t t = (size_t)blockIdx.x * blockDim.x + tid;
    const size_t stride = (size_t)gridDim.x * blockDim.x;
    copy_words(reinterpret_cast<const uint32_t*>(old_idx) + base,
               reinterpret_cast<uint32_t*>(idx) + base, nk, t, stride);
    copy_words(reinterpret_cast<const uint32_t*>(old_valid) + base,
               reinterpret_cast<uint32_t*>(valid) + base, nk, t, stride);
    return;
  }
  if (blockIdx.x != 0) return;
  const int n_cells = gx * gy * gz;
  const float* P = pos + (size_t)r * N * 3;
  int* C = cell_of + (size_t)r * N;

  // the bounding box (min and max are exact in any order)
  float b[6];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    b[c] = __int_as_float(0x7f800000);        // +inf
    b[3 + c] = __int_as_float(0xff800000);    // -inf
  }
  for (int i = tid; i < N; i += kBinThreads) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float p = P[3 * i + c];
      b[c] = fminf(b[c], p);
      b[3 + c] = fmaxf(b[3 + c], p);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      b[c] = fminf(b[c], __shfl_xor_sync(0xffffffffu, b[c], o));
      b[3 + c] = fmaxf(b[3 + c], __shfl_xor_sync(0xffffffffu, b[3 + c], o));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 6; ++c) s_red[c][warp] = b[c];
  }
  for (int c = tid; c < n_cells; c += kBinThreads) {
    s_cnt[c] = 0;
    s_run[c] = 0;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      float v = s_red[c][lane];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float u = __shfl_xor_sync(0xffffffffu, v, o);
        v = c < 3 ? fminf(v, u) : fmaxf(v, u);
      }
      if (lane == 0) s_box[c] = v;
    }
  }
  __syncthreads();

  // each atom's cell, and the cells' counts
  const int g[3] = {gx, gy, gz};
  float lo[3], width[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    lo[c] = s_box[c];
    width[c] = fmaxf(__fdiv_rn(__fsub_rn(s_box[3 + c], lo[c]), (float)g[c]),
                     r_list);
  }
  for (int i = tid; i < N; i += kBinThreads) {
    int cc[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int v = static_cast<int>(
          floorf(__fdiv_rn(__fsub_rn(P[3 * i + c], lo[c]), width[c])));
      cc[c] = min(max(v, 0), g[c] - 1);
    }
    const int cell = (cc[0] * gy + cc[1]) * gz + cc[2];
    C[i] = cell;
    atomicAdd(s_cnt + cell, 1);
  }
  __syncthreads();
  if (warp != 0) return;

  // warp 0: starts and kept counts (lane l owns a contiguous run of cells)
  const int per = (n_cells + 31) / 32;
  const int c0 = min(lane * per, n_cells), c1 = min(c0 + per, n_cells);
  int total = 0, lost = 0;
  for (int c = c0; c < c1; ++c) {
    total += s_cnt[c];
    lost += s_cnt[c] - min(s_cnt[c], cap);
  }
  int incl = total;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  int at = incl - total;
  for (int c = c0; c < c1; ++c) {
    const int k = s_cnt[c];
    start[(size_t)r * n_cells + c] = at;
    kept[(size_t)r * n_cells + c] = min(k, cap);
    s_cnt[c] = at;
    at += k;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    lost += __shfl_xor_sync(0xffffffffu, lost, o);
  if (lane == 0) dropped[r] = lost;
  __syncwarp();

  // ranks: the atoms in ascending index, 32 at a time
  int* S = order + (size_t)r * N;
  const unsigned below = (1u << lane) - 1u;
  int next = lane < N ? C[lane] : -1;
  for (int base = 0; base < N; base += 32) {
    const int i = base + lane;
    const int cell = next;
    next = i + 32 < N ? C[i + 32] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, cell);
    const int before = __popc(peers & below);
    if (i < N) S[s_cnt[cell] + s_run[cell] + before] = i;
    __syncwarp();
    if (i < N && before == 0) s_run[cell] += __popc(peers);
    __syncwarp();
  }
}

__global__ void __launch_bounds__(32 * kRowWarps) cell_rows_kernel(
    const float* __restrict__ pos, const uint32_t* __restrict__ bits,
    int nw, const int* __restrict__ flag, int flag_stride,
    const int* __restrict__ cell_of, const int* __restrict__ order,
    const int* __restrict__ start, const int* __restrict__ kept,
    int* __restrict__ idx, float* __restrict__ valid,
    int* __restrict__ dropped, int N, int K, int gx, int gy, int gz,
    float r_list2) {
  const int r = blockIdx.y;
  if (flag[(size_t)r * flag_stride] == 0) return;
  const int lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;
  const int n_cells = gx * gy * gz;
  const float* P = pos + (size_t)r * N * 3;
  const int* S = order + (size_t)r * N;
  const int* st = start + (size_t)r * n_cells;
  const int* kp = kept + (size_t)r * n_cells;
  const int ex = gx > 1 ? 1 : 0, ey = gy > 1 ? 1 : 0, ez = gz > 1 ? 1 : 0;
  // whole warps take rows, so every ballot has its 32 lanes
  for (int t = blockIdx.x * kRowWarps + threadIdx.x / 32; t < N;
       t += gridDim.x * kRowWarps) {
    const int i = S[t];                     // rows in cell order
    const uint32_t* mrow = bits + (size_t)i * nw;
    const int cell = cell_of[(size_t)r * N + i];
    const int cx = cell / (gy * gz), cy = (cell / gz) % gy, cz = cell % gz;
    const float xi = P[3 * i], yi = P[3 * i + 1], zi = P[3 * i + 2];
    int* row = idx + ((size_t)r * N + i) * K;
    float* vrow = valid + ((size_t)r * N + i) * K;
    int count = 0;                          // the same in every lane
    for (int dx = -ex; dx <= ex; ++dx) {
      const int nx = cx + dx;
      if (nx < 0 || nx >= gx) continue;
      for (int dy = -ey; dy <= ey; ++dy) {
        const int ny = cy + dy;
        if (ny < 0 || ny >= gy) continue;
        for (int dz = -ez; dz <= ez; ++dz) {
          const int nz = cz + dz;
          if (nz < 0 || nz >= gz) continue;
          const int nc = (nx * gy + ny) * gz + nz;
          const int s0 = st[nc], s1 = s0 + kp[nc];
          for (int b = s0; b < s1; b += 32) {  // rank order, 32 at a time
            const int s = b + lane;
            bool hit = false;
            int j = 0;
            if (s < s1) {
              j = S[s];
              if ((mrow[j >> 5] >> (j & 31)) & 1u) {
                const float r2 = r2_unfused(__fsub_rn(xi, P[3 * j]),
                                            __fsub_rn(yi, P[3 * j + 1]),
                                            __fsub_rn(zi, P[3 * j + 2]));
                hit = r2 <= r_list2;
              }
            }
            const unsigned hits = __ballot_sync(0xffffffffu, hit);
            const int slot = count + __popc(hits & below);
            if (hit && slot < K) row[slot] = j;
            count += __popc(hits);
          }
        }
      }
    }
    for (int k = lane; k < K; k += 32) {
      if (k >= count) row[k] = N;
      vrow[k] = k < count ? 1.0f : 0.0f;
    }
    if (lane == 0 && count > K) atomicAdd(dropped + r, count - K);
  }
}

}  // namespace

// bits: the pack's (ld, nw) mask bits; cell_of, order: (R, N) int32
// scratch; start, kept: (R, gx gy gz) int32 scratch.
extern "C" int cell_build_launch(const float* pos, const uint32_t* bits,
                                 int nw, const int* flag, int flag_stride,
                                 const int* old_idx, const float* old_valid,
                                 int* idx, float* valid, int* cell_of,
                                 int* order, int* start, int* kept,
                                 int* dropped, int R, int N, int K, int gx,
                                 int gy, int gz, int cap, float r_list,
                                 float r_list2, void* stream) {
  if (R == 0 || N == 0) return 0;
  const long n_cells = (long)gx * gy * gz;
  if (K < 1 || cap < 1 || gx < 1 || gy < 1 || gz < 1 ||
      n_cells > kMaxCells || nw < (N + 31) / 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t words = (size_t)N * K;
  const size_t copy_blocks = (words / 4 + kBinThreads - 1) / kBinThreads;
  const int g = static_cast<int>(copy_blocks > 1 ? copy_blocks : 1);
  cell_bin_kernel<<<dim3(g, R), kBinThreads, 0, st>>>(
      pos, flag, flag_stride, old_idx, old_valid, idx, valid, cell_of, order,
      start, kept, dropped, N, K, gx, gy, gz, cap, r_list);
  const int row_blocks = std::max(
      1, std::min((N + kRowWarps - 1) / kRowWarps,
                  std::max(1, kRowBlocks / R)));
  cell_rows_kernel<<<dim3(row_blocks, R), 32 * kRowWarps, 0, st>>>(
      pos, bits, nw, flag, flag_stride, cell_of, order, start, kept, idx,
      valid, dropped, N, K, gx, gy, gz, r_list2);
  return static_cast<int>(cudaGetLastError());
}
