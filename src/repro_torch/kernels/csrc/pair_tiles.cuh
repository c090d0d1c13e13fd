// Every unordered pair of atoms once, with Newton's third law and without
// float atomics: the tile-pair walk of the all-pairs kernels
// (lj_forces/csrc/nonbonded.cu, lj_forces/csrc/lj_fluid.cu's forces and
// energy kernels).
//
//   * The atoms are cut into n_t = ld / 64 tiles (ld a multiple of 128, so
//     n_t is even).  The host's schedule table (lj_forces/ops.py
//     tile_schedule, (n_t, n_t) int32) lists n_t rounds: round 0 the n_t
//     diagonal tiles, round u >= 1 the n_t / 2 disjoint tile pairs I < J of
//     round u - 1 of a round-robin tournament (the circle method); an
//     entry packs I | J << 16, -1 past the round's end.  Within a round no
//     two entries share a tile, so the warps of a block add their sums to
//     the block's force rows directly, and a barrier closes the round.
//   * A replica's rounds are split over S blocks (block s runs rounds s,
//     s + S, ...; S from lj_forces/ops.py block_split, a function of the
//     replica count and the atom count only).  Each block sums into its own
//     partial rows; a second, small launch adds the S partials in block
//     order.  The schedule and the split are fixed, so every sum is taken
//     in one order: bitwise identical from run to run.
//   * A warp takes one entry at a time.  For a pair of tiles, lane l owns
//     i-atoms 64 I + l and 64 I + 32 + l, their sums in registers, and
//     walks each 32-atom half of J in 32 steps, lane l meeting j =
//     (l + s) % 32 at step s; the j-side sums ride along, handed one lane
//     down by a shuffle after every step, so after 32 steps each is home.
//     A diagonal tile is walked the same way, its lower half against its
//     upper half, then each half against itself over 16 steps (the pair
//     (l, l + 16) from lane l < 16 only), so no self pair is formed.
//   * The partial rows are reached through a generic pointer: the fluid's
//     kernel keeps them in the partial-sum scratch in device memory, which
//     the 50 MB L2 holds at the sizes the paths run; the chain kernel keeps
//     them in shared memory where they fit beside the staging buffers
//     (lj_forces/ops.py rows_in_shared), else in that scratch too.  So N
//     has no ceiling.
//
// A policy P supplies the physics: kRows force sums per atom (0 for the
// fluid's energy kernel, whose walk carries no rows), kUnroll
// (the unroll of the 32-step walk, timed per kernel on the card), the
// i-atom constants (Atom, load_i), the staged j-atom (JAtom, stage,
// load_j), the pair term (pair<kMasked>: F_i += c d, F_j -= c d, energies
// if any), the 0/1 words of a tile pair that needs a guard (word) and the
// flag of one that does not (kept), and flush(), called after every tile
// entry (a policy with energy sums moves its per-entry sums into its
// totals there, two-level summation).  fused_baoab.cu keeps its own copy of this walk:
// its single salt-scaled force row is fused with the integrator update.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pt {

constexpr int kPT = 64;          // atoms per tile; PAIR_TILE in lj_forces/ops.py
constexpr int kMaxWarps = 24;    // MAX_WARPS in lj_forces/ops.py
constexpr int kMaxSmem = 232448; // SMEM_LIMIT in lj_forces/ops.py

// NR = 0 (a policy with energy sums only) keeps one unused float.
template <int NR>
struct Sums {
  float v[NR > 0 ? NR : 1];
  __device__ __forceinline__ Sums() {
#pragma unroll
    for (int k = 0; k < NR; ++k) v[k] = 0.f;
  }
};

template <int NR>
__device__ __forceinline__ void add(Sums<NR>& a, const Sums<NR>& b) {
#pragma unroll
  for (int k = 0; k < NR; ++k) a.v[k] += b.v[k];
}

template <int NR>
__device__ __forceinline__ void rotate(Sums<NR>& f, int src) {
#pragma unroll
  for (int k = 0; k < NR; ++k) f.v[k] = __shfl_sync(0xffffffffu, f.v[k], src);
}

// rows[k * ld + i] += f.v[k]: shared or device memory (a generic pointer)
template <int NR>
__device__ __forceinline__ void add_row(float* rows, int ld, int i,
                                        const Sums<NR>& f) {
#pragma unroll
  for (int k = 0; k < NR; ++k) rows[(size_t)k * ld + i] += f.v[k];
}

// 1 / sqrt(x) for x > 0 and not subnormal: one MUFU instruction, within
// 2^-22.9 relative, as rsqrtf.
__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 1 / x, the same way (within 1 ulp).
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Tiles I < J: every pair once, both sides.
template <bool kMasked, class P>
__device__ void tile_pair(P& p, int I, int J, int lane) {
  constexpr int NR = P::kRows;
  p.stage(J, lane);
  const int i0 = kPT * I + lane, i1 = i0 + 32;
  const typename P::Atom a0 = p.load_i(i0), a1 = p.load_i(i1);
  Sums<NR> f0, f1;
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    uint32_t b0 = 0u, b1 = 0u;
    if (kMasked) {
      b0 = p.word(i0, J, half);
      b1 = p.word(i1, J, half);
    }
    Sums<NR> fj;
#pragma unroll(P::kUnroll)
    for (int s = 0; s < 32; ++s) {
      const int jl = (lane + s) & 31;
      const typename P::JAtom j = p.load_j(32 * half + jl);
      p.template pair<kMasked>(a0, j, (float)((b0 >> jl) & 1u), f0, fj);
      p.template pair<kMasked>(a1, j, (float)((b1 >> jl) & 1u), f1, fj);
      rotate(fj, (lane + 1) & 31);   // lane l holds j = (l + s) % 32
    }
    add_row(p.rows, p.ld, kPT * J + 32 * half + lane, fj);   // home
  }
  add_row(p.rows, p.ld, i0, f0);
  add_row(p.rows, p.ld, i1, f1);
  p.flush();
}

// This lane's atom a against the 32 staged atoms of half h (0/1 word
// bits), lane l meeting j = (l + s) % 32 at steps s = first .. last; at
// s = 16 of a half with itself only lanes < 16 (the pair (l, l + 16)
// once).  Adds to fi; returns the j-side sums brought home (lane l: j = l).
template <class P>
__device__ __forceinline__ Sums<P::kRows> sweep_half(
    P& p, const typename P::Atom& a, uint32_t bits, int h, int first,
    int last, bool self, int lane, Sums<P::kRows>& fi) {
  Sums<P::kRows> fj;
#pragma unroll(P::kUnroll)
  for (int s = first; s <= last; ++s) {
    const int jl = (lane + s) & 31;
    if (!(self && s == 16 && lane >= 16)) {
      const typename P::JAtom j = p.load_j(32 * h + jl);
      p.template pair<true>(a, j, (float)((bits >> jl) & 1u), fi, fj);
    }
    rotate(fj, (lane + 1) & 31);
  }
  rotate(fj, (lane - last - 1) & 31);   // lane l holds l + last + 1
  return fj;
}

// Tile I with itself, every unordered pair once: the lower half (lane l's
// i0) against the upper half, whose sums come home to the lanes that own
// those atoms (i1 = i0 + 32), then each half against itself.
template <class P>
__device__ void tile_diag(P& p, int I, int lane) {
  p.stage(I, lane);
  const int i0 = kPT * I + lane, i1 = i0 + 32;
  const typename P::Atom a0 = p.load_i(i0), a1 = p.load_i(i1);
  Sums<P::kRows> f0, f1;
  Sums<P::kRows> fj =
      sweep_half(p, a0, p.word(i0, I, 1), 1, 0, 31, false, lane, f0);
  add(f1, fj);
  fj = sweep_half(p, a0, p.word(i0, I, 0), 0, 1, 16, true, lane, f0);
  add(f0, fj);
  fj = sweep_half(p, a1, p.word(i1, I, 1), 1, 1, 16, true, lane, f1);
  add(f1, fj);
  add_row(p.rows, p.ld, i0, f0);
  add_row(p.rows, p.ld, i1, f1);
  p.flush();
}

// The block's share of the schedule: rounds s, s + S, ... of the
// (n_t, n_t) table, each entry by one warp, a barrier after each round.
// Every thread of the block calls it; p.rows must be zeroed before.
template <class P>
__device__ void walk_rounds(P& p, const int* __restrict__ sched, int n_t,
                            int s, int S, int lane) {
  const int warp = threadIdx.x / 32, n_warps = blockDim.x / 32;
  for (int u = s; u < n_t; u += S) {
    const int* row = sched + (size_t)u * n_t;
    for (int k = warp; k < n_t; k += n_warps) {
      const int e = row[k];
      if (e < 0) break;
      const int I = e & 0xFFFF, J = e >> 16;
      if (I == J)
        tile_diag(p, I, lane);
      else if (p.kept(I, J))
        tile_pair<false>(p, I, J, lane);
      else
        tile_pair<true>(p, I, J, lane);
    }
    __syncthreads();
  }
}

// n floats of a block's rows: zero them, or copy them out (block-strided).
__device__ __forceinline__ void zero_rows(float* rows, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) rows[i] = 0.f;
}
__device__ __forceinline__ void copy_rows(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Warps of a block over n_t tiles: one per pair of a round, at most
// kMaxWarps (pair_warps in lj_forces/ops.py).
__host__ __device__ __forceinline__ int pair_warps(int n_t) {
  return n_t / 2 < kMaxWarps ? n_t / 2 : kMaxWarps;
}

// Dynamic shared memory of a launch: stage_bytes per staged j atom per
// warp, plus the rows when they live there (0 if over the limit).
inline int smem_bytes(int n_t, int stage_bytes, int row_floats) {
  const int bytes = pair_warps(n_t) * kPT * stage_bytes + row_floats * 4;
  return bytes <= kMaxSmem ? bytes : 0;
}

}  // namespace pt
