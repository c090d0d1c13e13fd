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
// What bounds it on an H100: bytes.  Positions in, the (R, N, K) list
// and dropped out, and the mask words of the pairs within r_list (the gas
// of 20,000 atoms: 102 MB of list); one distance test per pair within
// r_list is far less.  A build that culls nothing tests every stencil
// candidate, ~540 a row on the chain (its 16 x 3 x 2 grid puts ~180
// atoms in a cell) and ~670 on the gas, where ~100 a row lie within
// r_list.  The design with one bin block per replica was 22-123x its
// bytes bound: it ranked the atoms with warp 0 walking all N, 32 at a
// time, and its row pass gathered 3 position floats and one mask word per
// candidate, once per row of every cell sharing the stencil cell.
//
// Design: two launches per call (a third, for a scan across the bin
// blocks, would cost the flag-0 call, a copy of a few MB at R = 8, a
// launch's worth of time).
//   cell_bin_kernel, grid (max(copy blocks, B), R), 1024 threads: for a
//     replica with flag 0 the blocks copy its N K words of idx and of
//     valid (16-byte vectors);
//     with flag 1, bin block b < B (B = ceil(N / T) <= 16, T = 1024 a
//     atoms) takes atoms [b T, b T + T): it reduces the replica's whole
//     bounding box itself (min and max are exact in any order, so every
//     block gets the same box and no launch is spent on a partial-box
//     pass), writes its atoms' cells, counts them per cell in shared
//     memory (an integer sum), scans the counts into each cell's start
//     within the block's segment of the (R, N) cell order, writes (segment
//     start, count) to an (R, cells, B) table, and ranks its atoms
//     stably: rounds of 1024 atoms in ascending index, a lane's rank its
//     cell's running position plus the lanes below it in the same cell
//     (__match_any_sync), the warps' leaders taking positions in warp
//     order, one warp per __syncthreads; no atomic decides a rank.  Atom
//     i goes to (R, N, 4) float scratch at its position: x, y, z and i's
//     bits.  A cell's atoms in ascending index are then its B runs, block
//     by block: no scan across blocks is needed, so none costs a launch.
//   cell_rows_kernel, grid (G, R), G = min(cells, 2112 / R), w warps (up
//     to the cell's expected peak occupancy, C / 4 rows, in warps of 32,
//     at most 8, and at most half the card's warp slots over the grid):
//     block g walks cells g, g + G, ... of its replica; every warp reads
//     the cell's runs first, so an empty cell costs one load.  Warp 0
//     builds the table of the in-grid stencil cells' runs, each cell's
//     clipped to its first C atoms (the kept ones).  A thread per row, 32
//     rows a warp; the stencil's kept atoms in candidate order are staged
//     as float4 (704 at a time) once for all the cell's rows.  Rounds of
//     32 candidates: the lanes cull them against the warp's rows'
//     bounding box (gap^2 from the box formed as the rows' r2 is: every
//     row's r2 >= it, so gap^2 > r_list^2 drops no hit, and no margin is
//     needed), then every row tests every survivor, four at a time (a
//     broadcast read); a lane keeps its row's pairs within r_list as one
//     word a round.  The mask word is then read only for those pairs,
//     sixteen loads in flight a lane, and the words become the hits; a
//     lane's hits take its row's slots in candidate order (filling a row
//     at a time across the warp, by a prefix sum of the words, measured
//     slower: the warp then walks its 32 rows one by one).  Rows of K <=
//     32 slots are staged in shared memory and written out across the
//     warp, element by element; wider rows take their hits in place and
//     their padding row by row.  dropped gets integer atomics: a cell's
//     capacity drops, a warp's sum over rows of count - K.
//
// Measured (chip_smoke.py, PERF.md section 6): the rows set the pace;
// they are latency-bound (a few warps an SM, each waiting on its
// dependent loads), and on the gas the random mask reads over a 50 MB
// mask take most of their time.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "nlist_common.cuh"

namespace {

constexpr int kBinThreads = 1024;
constexpr int kMaxBinBlocks = 16;    // bin blocks (runs of a cell) a replica
constexpr int kMaxCells = 4096;
constexpr int kBatch = 704;          // candidates staged at a time (22 x 32)
constexpr int kMaxRowWarps = 8;
constexpr int kStageK = 32;          // rows staged in shared memory up to K
constexpr int kRowBlocks = 132 * 16; // row-pass blocks over the stack
constexpr int kRowWarpsOnCard = 132 * 32;  // half the card's warp slots
constexpr unsigned kAll = 0xffffffffu;

// How far c lies outside [lo, hi], formed as a row's dx is (0 inside).
__device__ __forceinline__ float gap(float lo, float hi, float c) {
  return fmaxf(fmaxf(__fsub_rn(lo, c), __fsub_rn(c, hi)), 0.0f);
}

__device__ __forceinline__ int warp_inclusive_sum(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kAll, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

__global__ void __launch_bounds__(kBinThreads) cell_bin_kernel(
    const float* __restrict__ pos, const int* __restrict__ flag,
    int flag_stride, const int* __restrict__ old_idx,
    const float* __restrict__ old_valid, int* __restrict__ idx,
    float* __restrict__ valid, int* __restrict__ cell_of,
    float4* __restrict__ posc, int2* __restrict__ tab,
    int* __restrict__ dropped, int N, int K, int gx, int gy, int gz, int T,
    float r_list) {
  __shared__ int s_at[kMaxCells];    // counts, then each cell's next slot
  __shared__ float s_red[6][32];
  __shared__ float s_box[6];
  __shared__ int s_wsum[32];
  const int r = blockIdx.y, b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (flag[(size_t)r * flag_stride] == 0) {
    if (b == 0 && tid == 0) dropped[r] = 0;
    const size_t nk = (size_t)N * K, base = (size_t)r * nk;
    const size_t t = (size_t)b * blockDim.x + tid;
    const size_t stride = (size_t)gridDim.x * blockDim.x;
    copy_words(reinterpret_cast<const uint32_t*>(old_idx) + base,
               reinterpret_cast<uint32_t*>(idx) + base, nk, t, stride);
    copy_words(reinterpret_cast<const uint32_t*>(old_valid) + base,
               reinterpret_cast<uint32_t*>(valid) + base, nk, t, stride);
    return;
  }
  const int B = (N + T - 1) / T;
  if (b >= B) return;
  if (b == 0 && tid == 0) dropped[r] = 0;
  const int n_cells = gx * gy * gz;
  const float* P = pos + (size_t)r * N * 3;
  int* C = cell_of + (size_t)r * N;

  // the replica's bounding box, in every bin block
  float bx[6];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    bx[c] = __int_as_float(0x7f800000);        // +inf
    bx[3 + c] = __int_as_float(0xff800000);    // -inf
  }
  for (int i = tid; i < N; i += kBinThreads) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float p = P[3 * i + c];
      bx[c] = fminf(bx[c], p);
      bx[3 + c] = fmaxf(bx[3 + c], p);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      bx[c] = fminf(bx[c], __shfl_xor_sync(kAll, bx[c], o));
      bx[3 + c] = fmaxf(bx[3 + c], __shfl_xor_sync(kAll, bx[3 + c], o));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 6; ++c) s_red[c][warp] = bx[c];
  }
  for (int c = tid; c < n_cells; c += kBinThreads) s_at[c] = 0;
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      float v = s_red[c][lane];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float u = __shfl_xor_sync(kAll, v, o);
        v = c < 3 ? fminf(v, u) : fmaxf(v, u);
      }
      if (lane == 0) s_box[c] = v;
    }
  }
  __syncthreads();

  // the block's atoms' cells, and their counts
  const int g[3] = {gx, gy, gz};
  float lo[3], width[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    lo[c] = s_box[c];
    width[c] = fmaxf(__fdiv_rn(__fsub_rn(s_box[3 + c], lo[c]), (float)g[c]),
                     r_list);
  }
  const int i0 = b * T, i1 = min(i0 + T, N);
  for (int i = i0 + tid; i < i1; i += kBinThreads) {
    int cc[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int v = static_cast<int>(
          floorf(__fdiv_rn(__fsub_rn(P[3 * i + c], lo[c]), width[c])));
      cc[c] = min(max(v, 0), g[c] - 1);
    }
    const int cell = (cc[0] * gy + cc[1]) * gz + cc[2];
    C[i] = cell;
    atomicAdd(s_at + cell, 1);
  }
  __syncthreads();

  // each cell's start in the segment (thread t scans cells 4t .. 4t + 3),
  // and the (segment start, count) table
  int cnt[4], sum = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int c = 4 * tid + u;
    cnt[u] = c < n_cells ? s_at[c] : 0;
    sum += cnt[u];
  }
  const int incl = warp_inclusive_sum(sum, lane);
  if (lane == 31) s_wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = s_wsum[lane];
    const int wi = warp_inclusive_sum(w, lane);
    __syncwarp();
    s_wsum[lane] = wi - w;
  }
  __syncthreads();
  int at = s_wsum[warp] + incl - sum;
  int2* tb = tab + (size_t)r * n_cells * B;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int c = 4 * tid + u;
    if (c < n_cells) {
      tb[(size_t)c * B + b] = make_int2(i0 + at, cnt[u]);
      s_at[c] = at;
      at += cnt[u];
    }
  }
  __syncthreads();

  // stable ranks, 1024 atoms a round in ascending index: the lanes of one
  // cell take consecutive slots, the warps in order
  const unsigned below = (1u << lane) - 1u;
  float4* Q = posc + (size_t)r * N + i0;
  for (int base = i0; base < i1; base += kBinThreads) {
    const int i = base + tid;
    const int cell = i < i1 ? C[i] : -1;
    const unsigned peers = __match_any_sync(kAll, cell);
    const int leader = __ffs(peers) - 1;
    int slot = 0;
    for (int w = 0; w < kBinThreads / 32; ++w) {
      if (warp == w && lane == leader && cell >= 0) {
        slot = s_at[cell];
        s_at[cell] = slot + __popc(peers);
      }
      __syncthreads();
    }
    slot = __shfl_sync(kAll, slot, leader) + __popc(peers & below);
    if (cell >= 0)
      Q[slot] = make_float4(P[3 * i], P[3 * i + 1], P[3 * i + 2],
                            __int_as_float(i));
  }
}

__global__ void __launch_bounds__(32 * kMaxRowWarps) cell_rows_kernel(
    const float4* __restrict__ posc, const int2* __restrict__ tab,
    const uint32_t* __restrict__ bits, int nw, const int* __restrict__ flag,
    int flag_stride, int* __restrict__ idx, float* __restrict__ valid,
    int* __restrict__ dropped, int N, int K, int gx, int gy, int gz, int B,
    int cap, float r_list2) {
  const int r = blockIdx.y;
  if (flag[(size_t)r * flag_stride] == 0) return;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_cells = gx * gy * gz;
  const int nx = gx > 1 ? 3 : 1, ny = gy > 1 ? 3 : 1, nz = gz > 1 ? 3 : 1;
  const int n_st = nx * ny * nz, n_runs = n_st * B;
  const bool stage = K <= kStageK;
  // shared memory: staged candidates; each warp's per-round words (the
  // rows' near pairs, then their hits); the stencil's runs (start,
  // offset); the cell's own runs (start, offset); staged rows
  extern __shared__ float4 smem[];
  float4* s_cand = smem;
  unsigned* s_word = reinterpret_cast<unsigned*>(s_cand + kBatch) +
                     warp * kBatch + lane;     // round k at s_word[32 k]
  int* s_rs = reinterpret_cast<int*>(s_cand + kBatch) +
              (blockDim.x / 32) * kBatch;
  int* s_ro = s_rs + n_runs;
  int* s_os = s_ro + n_runs + 1;
  int* s_oo = s_os + B;
  int* s_out = s_oo + B + 1;
  const float4* Q = posc + (size_t)r * N;
  const int2* tb = tab + (size_t)r * n_cells * B;

  for (int c = blockIdx.x; c < n_cells; c += gridDim.x) {
    // every warp reads the cell's own runs: an empty cell costs one load
    const int2 own = lane < B ? tb[(size_t)c * B + lane] : make_int2(0, 0);
    const int oi = warp_inclusive_sum(own.y, lane);
    const int total = __shfl_sync(kAll, oi, 31);
    if (total == 0) continue;
    __syncthreads();                 // the last cell's shared memory is free
    if (warp == 0) {
      if (lane < B) {
        s_os[lane] = own.x;
        s_oo[lane] = oi - own.y;
      }
      if (lane == 0) s_oo[B] = total;
      // the stencil's runs, lane s for stencil cell s: each cell's first
      // `cap` atoms, its runs in block order
      int kept = 0;
      if (lane < n_st) {
        const int x = c / (gy * gz) + lane / (ny * nz) - (nx > 1);
        const int y = (c / gz) % gy + (lane / nz) % ny - (ny > 1);
        const int z = c % gz + lane % nz - (nz > 1);
        const bool in = x >= 0 && x < gx && y >= 0 && y < gy && z >= 0 &&
                        z < gz;
        const int2* row = tb + (size_t)((x * gy + y) * gz + z) * B;
        int2 t[kMaxBinBlocks];
#pragma unroll
        for (int bb = 0; bb < kMaxBinBlocks; ++bb)
          t[bb] = in && bb < B ? row[bb] : make_int2(0, 0);
        int seen = 0;
#pragma unroll
        for (int bb = 0; bb < kMaxBinBlocks; ++bb) {
          if (bb < B) {
            const int len = min(t[bb].y, max(cap - seen, 0));
            seen += t[bb].y;
            s_rs[lane * B + bb] = t[bb].x;
            s_ro[lane * B + bb] = len;
            kept += len;
          }
        }
      }
      const int ki = warp_inclusive_sum(kept, lane);
      if (lane < n_st) {
        int at = ki - kept;
        for (int bb = 0; bb < B; ++bb) {
          const int len = s_ro[lane * B + bb];
          s_ro[lane * B + bb] = at;
          at += len;
        }
      }
      if (lane == 31) s_ro[n_runs] = ki;
    }
    __syncthreads();
    const int M = s_ro[n_runs];
    if (tid == 0 && total > cap) atomicAdd(dropped + r, total - cap);

    for (int q0 = 0; q0 < total; q0 += blockDim.x) {
      const int q = q0 + warp * 32 + lane;
      const bool active = q < total;
      float4 me = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (active) {
        int bb = 0;
        while (bb + 1 < B && s_oo[bb + 1] <= q) ++bb;
        me = Q[s_os[bb] + q - s_oo[bb]];
      }
      const int i = __float_as_int(me.w);
      // the warp's rows' bounding box
      float lo[3] = {me.x, me.y, me.z}, hi[3] = {me.x, me.y, me.z};
      if (!active) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          lo[a] = __int_as_float(0x7f800000);
          hi[a] = __int_as_float(0xff800000);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          lo[a] = fminf(lo[a], __shfl_xor_sync(kAll, lo[a], o));
          hi[a] = fmaxf(hi[a], __shfl_xor_sync(kAll, hi[a], o));
        }
      }
      const bool busy = __any_sync(kAll, active);
      int* dst = stage ? s_out + (warp * 32 + lane) * K
                       : idx + ((size_t)r * N + i) * K;
      const uint32_t* mrow = bits + (size_t)i * nw;
      int count = 0;
      for (int m0 = 0; m0 < M; m0 += kBatch) {
        const int nb = min(kBatch, M - m0), rounds = (nb + 31) / 32;
        if (q0 == 0 || M > kBatch) {
          __syncthreads();
          for (int m = m0 + tid; m < m0 + nb; m += 4 * blockDim.x) {
            int a[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int mu = m + u * blockDim.x;
              int z = n_runs;          // s_ro[a] <= mu < s_ro[z]
              a[u] = 0;
              while (z - a[u] > 1) {
                const int h = (a[u] + z) / 2;
                if (s_ro[h] <= mu) a[u] = h; else z = h;
              }
            }
            float4 v[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int mu = m + u * blockDim.x;
              if (mu < m0 + nb) v[u] = Q[s_rs[a[u]] + mu - s_ro[a[u]]];
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int mu = m + u * blockDim.x;
              if (mu < m0 + nb) s_cand[mu - m0] = v[u];
            }
          }
          __syncthreads();
        }
        if (!busy) continue;
        // each round of 32 candidates: the cull, then every survivor
        // against every row, four at a time; a lane's near pairs as bits
        for (int k = 0; k < rounds; ++k) {
          const int k0 = 32 * k;
          bool keep = false;
          if (k0 + lane < nb) {
            const float4 cd = s_cand[k0 + lane];
            keep = !(r2_unfused(gap(lo[0], hi[0], cd.x),
                                gap(lo[1], hi[1], cd.y),
                                gap(lo[2], hi[2], cd.z)) > r_list2);
          }
          unsigned near = 0;
          for (unsigned sv = __ballot_sync(kAll, keep); sv;) {
            int l[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              l[u] = sv ? __ffs(sv) - 1 : -1;
              sv &= sv - 1;
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float4 cd = s_cand[k0 + max(l[u], 0)];
              const float r2 = r2_unfused(__fsub_rn(me.x, cd.x),
                                          __fsub_rn(me.y, cd.y),
                                          __fsub_rn(me.z, cd.z));
              if (l[u] >= 0 && r2 <= r_list2) near |= 1u << l[u];
            }
          }
          s_word[32 * k] = active ? near : 0u;
        }
        // the mask bits of the near pairs, sixteen loads in flight a lane;
        // a round's word turns into its hits
        int k = 0;
        unsigned cur = s_word[0];
        s_word[0] = 0;
        for (;;) {
          int kk[16], l[16], j[16];
#pragma unroll
          for (int u = 0; u < 16; ++u) {
            while (cur == 0 && k + 1 < rounds) {
              cur = s_word[32 * ++k];
              s_word[32 * k] = 0;
            }
            l[u] = cur ? __ffs(cur) - 1 : -1;
            cur &= cur - 1;
            kk[u] = k;
            j[u] = l[u] >= 0 ? __float_as_int(s_cand[32 * k + l[u]].w) : 0;
          }
          if (l[0] < 0) break;
          uint32_t w[16];
#pragma unroll
          for (int u = 0; u < 16; ++u)
            if (l[u] >= 0) w[u] = __ldg(mrow + (j[u] >> 5));
#pragma unroll
          for (int u = 0; u < 16; ++u)
            if (l[u] >= 0 && ((w[u] >> (j[u] & 31)) & 1u))
              s_word[32 * kk[u]] |= 1u << l[u];
        }
        // the hits take the row's slots in candidate order
        for (int kr = 0; kr < rounds; ++kr) {
          for (unsigned h = s_word[32 * kr]; h; h &= h - 1) {
            if (count < K)
              dst[count] = __float_as_int(s_cand[32 * kr + __ffs(h) - 1].w);
            ++count;
          }
        }
      }
      __syncwarp();
      // the warp's rows out: staged rows element by element across the
      // warp, rows written in place padded row by row
      const int rows_here = min(32, total - q0 - warp * 32);
      if (stage) {
        for (int e = lane; e < 32 * K; e += 32) {
          const int rr = e / K, kx = e - rr * K;
          const int n_r = __shfl_sync(kAll, count, rr);
          const int i_r = __shfl_sync(kAll, i, rr);
          if (rr < rows_here) {
            const size_t at = ((size_t)r * N + i_r) * K + kx;
            idx[at] = kx < n_r ? s_out[(warp * 32 + rr) * K + kx] : N;
            valid[at] = kx < n_r ? 1.0f : 0.0f;
          }
        }
      } else {
        for (int rr = 0; rr < rows_here; ++rr) {
          const int n_r = __shfl_sync(kAll, count, rr);
          const size_t at = ((size_t)r * N + __shfl_sync(kAll, i, rr)) * K;
          for (int kx = lane; kx < K; kx += 32) {
            if (kx >= n_r) idx[at + kx] = N;
            valid[at + kx] = kx < n_r ? 1.0f : 0.0f;
          }
        }
      }
      int over = active && count > K ? count - K : 0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) over += __shfl_xor_sync(kAll, over, o);
      if (lane == 0 && over > 0) atomicAdd(dropped + r, over);
      __syncwarp();
    }
  }
}

}  // namespace

// bits: the pack's (ld, nw) mask bits; cell_of: (R, N) int32, posc: (R,
// N, 4) float32 and tab: (R, gx gy gz, ceil(N / bin_block), 2) int32
// scratch; bin_block: atoms a bin block (a multiple of 1024, at most 16
// blocks a replica).
extern "C" int cell_build_launch(const float* pos, const uint32_t* bits,
                                 int nw, const int* flag, int flag_stride,
                                 const int* old_idx, const float* old_valid,
                                 int* idx, float* valid, int* cell_of,
                                 float* posc, int* tab, int* dropped, int R,
                                 int N, int K, int gx, int gy, int gz,
                                 int cap, int bin_block, float r_list,
                                 float r_list2, void* stream) {
  if (R == 0 || N == 0) return 0;
  const long n_cells = (long)gx * gy * gz;
  if (K < 1 || cap < 1 || gx < 1 || gy < 1 || gz < 1 ||
      n_cells > kMaxCells || nw < (N + 31) / 32 || bin_block < kBinThreads ||
      bin_block % kBinThreads != 0 ||
      (N + bin_block - 1) / bin_block > kMaxBinBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int B = (N + bin_block - 1) / bin_block;
  const size_t words = (size_t)N * K;
  const size_t copy_blocks = (words / 4 + kBinThreads - 1) / kBinThreads;
  const int g = static_cast<int>(std::max<size_t>(copy_blocks, B));
  cell_bin_kernel<<<dim3(g, R), kBinThreads, 0, st>>>(
      pos, flag, flag_stride, old_idx, old_valid, idx, valid, cell_of,
      reinterpret_cast<float4*>(posc), reinterpret_cast<int2*>(tab), dropped,
      N, K, gx, gy, gz, bin_block, r_list);
  const int blocks = static_cast<int>(
      std::min<long>(n_cells, std::max(1, kRowBlocks / R)));
  const int warps = std::max(1, std::min({kMaxRowWarps, (cap + 127) / 128,
                                          kRowWarpsOnCard / (blocks * R)}));
  const int n_st = (gx > 1 ? 3 : 1) * (gy > 1 ? 3 : 1) * (gz > 1 ? 3 : 1);
  const size_t smem = (sizeof(float4) + sizeof(unsigned) * warps) * kBatch +
                      sizeof(int) * (2 * n_st * B + 1 + 2 * B + 1) +
                      (K <= kStageK ? sizeof(int) * 32 * warps * K : 0);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(cell_rows_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  cell_rows_kernel<<<dim3(blocks, R), 32 * warps, smem, st>>>(
      reinterpret_cast<const float4*>(posc),
      reinterpret_cast<const int2*>(tab), bits, nw, flag, flag_stride, idx,
      valid, dropped, N, K, gx, gy, gz, B, cap, r_list2);
  return static_cast<int>(cudaGetLastError());
}
