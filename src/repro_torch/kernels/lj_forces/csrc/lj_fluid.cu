// Lennard-Jones fluid of a replica stack, written for Hopper (sm_90a): the
// total energy per replica and the forces, uniform sigma and eps, every
// pair under the minimum-image periodic box.
//
// Replaces: src/repro/kernels/lj_forces/kernel.py
//   lj_energy_kernel_batched (pl.pallas_call at :104, body
//   _energy_kernel_batched at :59) and lj_forces_kernel_batched
//   (pl.pallas_call at :126, body _forces_kernel_batched at :74), both
//   through the tile _pair_blocks at :32.
//
// What bounds them on an H100: operations.  At R = 64, N = 864 each
// function needs each of 2.4e7 unordered pairs once; the bytes are
// positions in and forces (or one energy per replica) out, 1.3 MB at
// most.
//
// Both kernels visit each unordered pair once, through the tile-pair walk
// of ../../csrc/pair_tiles.cuh (shared with nonbonded.cu): 64-atom tile
// pairs on a round-robin schedule, no float atomics, each replica's rounds
// split over S blocks (lj_forces/ops.py block_split, two waves: S = 14 at
// R = 64, N = 864, one round per block, 896 blocks of 7 warps, four
// resident per SM).
//
// The energy kernel (a policy with no force rows): each lane sums the
// pair terms s6 (s6 - 1) of one tile entry (at most 128 pairs, all at
// similar distances), moves that sum into its running sum over its
// entries; after the walk the lanes of a warp are added in a fixed
// butterfly, the warps of a block in warp order, into an (R, S) scratch,
// and a second launch adds each replica's S block sums in block order and
// scales by 4 eps.  Each pair enters once, so nothing is halved.  No
// register ever holds a sum over all j of an atom: an earlier design (one
// thread per atom, every ordered pair, IEEE divisions) did, and at
// N = 17,500 its float32 sums lost the far pairs' terms (each under half
// an ulp of the running sum), 4e-5 to 8e-5 of the energy.
// The order depends on (R, N) only, so run_fused stays bitwise chunk-size
// invariant.
//
// The forces kernel: Newton's third law with the j-side sums handed down
// the warp by shuffles, three force sums per atom, each block into its
// own partial rows in device memory (3 x ld floats per block, 9.6 MB at
// R = 64, N = 864, held by the L2; rows in shared memory timed no faster
// on an H100, and device rows put no ceiling on N), which a second launch
// adds in block order and scales by 24 eps.  Per pair no division:
//   * the minimum image by one reciprocal, d - box * rint(d * inv_box),
//     inv_box the float32 reciprocal formed once on the host, rint half to
//     even as two float adds of 1.5 * 2^23 (exact for |x| < 2^22; the
//     FRND instruction issues at a quarter of the FMA rate).  It differs
//     from d / box only where d / box is within an ulp of +-1/2 but not on
//     it: a pair near half the box, where the force is small.  The image
//     is odd in d, so F_ij = -F_ji;
//   * inv_r2 = rcp(r2) (one MUFU instruction), tt = sigma^2 inv_r2,
//     s6 = tt^3, c = s6 (2 s6 - 1) inv_r2.
// The energy takes the same image and inv_r2, then s6 (s6 - 1).  Only the
// diagonal tiles and the ragged last tile take a guard: a pair with an
// atom past N gets r2 += 1 - m, its term times m (m = 0), so it adds
// exactly zero.  The constants sigma^2, 4 eps, 24 eps and box arrive as
// the float32 values JAX forms (lj_forces/ref.py::fluid_constants).
#include <cuda_runtime.h>

#include "pair_tiles.cuh"

namespace {

using pt::kPT;
using pt::Sums;

// rint(x), half to even, for |x| < 2^22: the sum with 1.5 * 2^23 rounds x
// to an integer in the default rounding mode; __fadd_rn / __fsub_rn are
// never contracted or reassociated.
__device__ __forceinline__ float rint_small(float x) {
  return __fsub_rn(__fadd_rn(x, 12582912.0f), 12582912.0f);
}

constexpr int kStageBytes = 16;   // a staged j atom: float4 (x, y, z, -)

// What both kernels' walks share: the atoms, the staging, the guards and
// the minimum image.
struct FluidBase {
  struct Atom {
    float x, y, z;
  };
  using JAtom = float4;

  const float* P;      // this replica's (N, 3) positions
  float4* jx;          // this warp's staged j atoms
  float* rows;         // the block's (3, ld) partial force rows (device)
  int ld, N;
  float box, inv_box, sig2;

  __device__ __forceinline__ Atom load_i(int i) const {
    if (i >= N) return {0.f, 0.f, 0.f};
    return {P[3 * i], P[3 * i + 1], P[3 * i + 2]};
  }

  __device__ __forceinline__ void stage(int t, int lane) const {
    __syncwarp();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int jl = lane + 32 * u, j = kPT * t + jl;
      jx[jl] = j < N ? make_float4(P[3 * j], P[3 * j + 1], P[3 * j + 2], 0.f)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncwarp();
  }

  __device__ __forceinline__ JAtom load_j(int jj) const { return jx[jj]; }

  // Bit b: atom i and atom 64 J + 32 h + b are both real.
  __device__ __forceinline__ uint32_t word(int i, int J, int h) const {
    const int n = N - (kPT * J + 32 * h);
    if (i >= N || n <= 0) return 0u;
    return n >= 32 ? 0xffffffffu : (1u << n) - 1u;
  }

  // I < J: both tiles hold only real atoms.
  __device__ __forceinline__ bool kept(int, int J) const {
    return kPT * (J + 1) <= N;
  }

  __device__ __forceinline__ float image(float d) const {
    return d - box * rint_small(d * inv_box);
  }

  // Minimum-image displacement and 1 / r^2 (guarded where kMasked).
  template <bool kMasked>
  __device__ __forceinline__ float inv_r2(const Atom& a, const JAtom& j,
                                          float m, float& dx, float& dy,
                                          float& dz) const {
    dx = image(a.x - j.x);
    dy = image(a.y - j.y);
    dz = image(a.z - j.z);
    float r2 = dx * dx + dy * dy + dz * dz;
    if (kMasked) r2 += 1.0f - m;
    return pt::rcp_approx(r2);
  }
};

struct FluidPair : FluidBase {
  static constexpr int kRows = 3;
  // unroll of the walk: the fastest of 1, 2, 3, 4, 8 and 16 at R = 64,
  // N = 864 on an H100 80GB HBM3 (700 W), every one bitwise the same sums
  static constexpr int kUnroll = 8;

  template <bool kMasked>
  __device__ __forceinline__ void pair(const Atom& a, const JAtom& j,
                                       float m, Sums<kRows>& fi,
                                       Sums<kRows>& fj) const {
    float dx, dy, dz;
    const float ir2 = inv_r2<kMasked>(a, j, m, dx, dy, dz);
    const float tt = sig2 * ir2;
    const float s6 = tt * (tt * tt);
    float c = s6 * (2.0f * s6 - 1.0f) * ir2;
    if (kMasked) c *= m;
    fi.v[0] += c * dx;
    fi.v[1] += c * dy;
    fi.v[2] += c * dz;
    fj.v[0] -= c * dx;
    fj.v[1] -= c * dy;
    fj.v[2] -= c * dz;
  }

  __device__ __forceinline__ void flush() const {}
};

// The energy: no force rows; each lane's sum of the current tile entry
// (e) and over its entries (t), two-level summation.
struct FluidEnergy : FluidBase {
  static constexpr int kRows = 0;
  static constexpr int kUnroll = 8;
  float e = 0.f, t = 0.f;

  template <bool kMasked>
  __device__ __forceinline__ void pair(const Atom& a, const JAtom& j,
                                       float m, Sums<kRows>&, Sums<kRows>&) {
    float dx, dy, dz;
    const float ir2 = inv_r2<kMasked>(a, j, m, dx, dy, dz);
    const float tt = sig2 * ir2;
    const float s6 = tt * (tt * tt);
    float u = s6 * (s6 - 1.0f);
    if (kMasked) u *= m;
    e += u;
  }

  __device__ __forceinline__ void flush() {
    t += e;
    e = 0.f;
  }
};

__device__ __forceinline__ void init(FluidBase& p, const float* pos,
                                     float4* smem4, float* rows, int N,
                                     int ld, float box, float inv_box,
                                     float sig2) {
  const int r = blockIdx.y, warp = threadIdx.x / 32;
  p.P = pos + (size_t)r * N * 3;
  p.jx = smem4 + warp * kPT;
  p.rows = rows;
  p.ld = ld;
  p.N = N;
  p.box = box;
  p.inv_box = inv_box;
  p.sig2 = sig2;
}

// Sum over the warp in a fixed butterfly order (every lane gets it).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block s of replica r: its rounds of the schedule, its lanes' sums added
// in a fixed order into e_part[r, s].
__global__ void __launch_bounds__(32 * pt::kMaxWarps)
    lj_energy_pairs_kernel(const float* __restrict__ pos,
                           const int* __restrict__ sched,
                           float* __restrict__ e_part, int N, int ld, int S,
                           float box, float inv_box, float sig2) {
  extern __shared__ float4 smem4[];
  const int s = blockIdx.x, r = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  FluidEnergy p;
  init(p, pos, smem4, nullptr, N, ld, box, inv_box, sig2);
  pt::walk_rounds(p, sched, ld / kPT, s, S, lane);
  // the staging buffers are free after the last round's barrier
  float* red = reinterpret_cast<float*>(smem4);
  const float w = warp_sum(p.t);
  if (lane == 0) red[warp] = w;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = 0.f;
    for (int k = 0; k < n_warps; ++k) b += red[k];
    e_part[(size_t)r * S + s] = b;
  }
}

// energy[r] = 4 eps x the in-order sum of replica r's S block sums.
__global__ void lj_energy_combine_kernel(const float* __restrict__ e_part,
                                         float* __restrict__ energy, int R,
                                         int S, float c4) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float* ep = e_part + (size_t)r * S;
  float b = 0.f;
  for (int k = 0; k < S; ++k) b += ep[k];
  energy[r] = c4 * b;
}

// Block s of replica r: its rounds of the schedule into its partial rows
// part[r, s] (3, ld).
__global__ void __launch_bounds__(32 * pt::kMaxWarps)
    lj_forces_pairs_kernel(const float* __restrict__ pos,
                           const int* __restrict__ sched,
                           float* __restrict__ part, int N, int ld, int S,
                           float box, float inv_box, float sig2) {
  constexpr int kRows = FluidPair::kRows;
  extern __shared__ float4 smem4[];
  const int s = blockIdx.x, r = blockIdx.y;
  const int lane = threadIdx.x % 32;

  FluidPair p;
  init(p, pos, smem4, part + ((size_t)r * S + s) * kRows * ld, N, ld, box,
       inv_box, sig2);

  pt::zero_rows(p.rows, kRows * ld);
  __syncthreads();
  pt::walk_rounds(p, sched, ld / kPT, s, S, lane);
}

// forces = 24 eps x the S partials of each replica added in block order.
__global__ void lj_forces_combine_kernel(const float* __restrict__ part,
                                         float* __restrict__ forces, int N,
                                         int ld, int S, float c24) {
  constexpr int kRows = FluidPair::kRows;
  const int r = blockIdx.y, i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  float acc[kRows] = {0.f, 0.f, 0.f};
  for (int s = 0; s < S; ++s) {
    const float* src = part + ((size_t)r * S + s) * kRows * ld + i;
#pragma unroll
    for (int k = 0; k < kRows; ++k) acc[k] += src[(size_t)k * ld];
  }
  float* F = forces + ((size_t)r * N + i) * 3;
#pragma unroll
  for (int k = 0; k < kRows; ++k) F[k] = c24 * acc[k];
}

}  // namespace

// sched: the (ld / 64, ld / 64) round table; part: (R, S, 3, ld) scratch;
// inv_box: the float32 1 / box (0 for no box).
extern "C" int lj_forces_launch(const float* pos, const int* sched,
                                float* part, float* forces, int R, int N,
                                int ld, int S, float box, float inv_box,
                                float sig2, float c24, void* stream) {
  if (R == 0 || N == 0) return 0;
  const int n_t = ld / kPT;
  if (ld % (2 * kPT) != 0 || ld < N || S < 1 || S > n_t)
    return static_cast<int>(cudaErrorInvalidValue);
  // the staged j atoms alone: at most 24 warps x 1 KB, under the 48 KB
  // that needs no opt-in
  const int smem = pt::pair_warps(n_t) * kPT * kStageBytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  lj_forces_pairs_kernel<<<dim3(S, R), 32 * pt::pair_warps(n_t), smem,
                           st>>>(pos, sched, part, N, ld, S, box, inv_box,
                                 sig2);
  lj_forces_combine_kernel<<<dim3((N + 127) / 128, R), 128, 0, st>>>(
      part, forces, N, ld, S, c24);
  return static_cast<int>(cudaGetLastError());
}

// sched: as for the forces; e_part: (R, S) scratch.
extern "C" int lj_energy_launch(const float* pos, const int* sched,
                                float* e_part, float* energy, int R, int N,
                                int ld, int S, float box, float inv_box,
                                float sig2, float c4, void* stream) {
  if (R == 0) return 0;          // N = 0 runs: every pair masked, energy 0
  const int n_t = ld / kPT;
  if (ld % (2 * kPT) != 0 || ld < N || S < 1 || S > n_t)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = pt::pair_warps(n_t) * kPT * kStageBytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  lj_energy_pairs_kernel<<<dim3(S, R), 32 * pt::pair_warps(n_t), smem,
                           st>>>(pos, sched, e_part, N, ld, S, box, inv_box,
                                 sig2);
  lj_energy_combine_kernel<<<(R + 127) / 128, 128, 0, st>>>(e_part, energy,
                                                            R, S, c4);
  return static_cast<int>(cudaGetLastError());
}
