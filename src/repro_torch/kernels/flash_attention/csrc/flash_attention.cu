// Causal / sliding-window attention, forward only, written for Hopper
// (sm_90a): blockwise online softmax over key tiles, grouped kv heads read
// in place, an optional logit softcap.  q and k share a head dim D, v and
// the output have their own, Dv (MLA attends at D = 192, Dv = 128); each
// up to 256.  Two variants, one entry point:
//   * bfloat16 in and out: the products on the tensor cores (wgmma, bf16
//     operands, float32 accumulators), tiles brought in by TMA;
//   * float32 in and out: float32 FMAs on the CUDA cores (TF32 products
//     would keep about three decimal digits, short of the float32
//     allowance of its plain version).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py
//   flash_attention_kernel (pl.pallas_call at :101, body _attn_kernel at
//   :26), called in the model layout through ops.py:29 flash_attention.
//
// What bounds it on an H100: operations.  At the OLMo-1B prefill shape
// (B = 4, S = T = 2048, H = G = 16, D = 128, causal) the function needs
// 4 B H D S (S + 1) / 2 = 6.9e10 operations (two products per kept
// (query, key) pair) against 134 MB of q, k, v and out: 0.069 ms at the
// tensor cores' bf16 rate, 0.040 ms for the bytes.
//
// Shared by both variants: the key loop of a q-tile is bounded by the
// causal diagonal and the window (the TPU kernel's relevant() tile skip
// as loop bounds); q-tiles are issued last first, so the long causal rows
// start early; each score is scaled by 1 / sqrt(D) (q's true D), then
// softcapped, s = tanh(s / c) c, then masked: masked keys (causal, window,
// the tail past T) get -inf, so they add exp(-inf) = 0 while the running
// max m starts at -1e30 and stays finite; m, the sum l and the output
// accumulator are rescaled by exp(m_old - m_new).  Out: acc / max(l,
// 1e-30) rounded to the input dtype (round to nearest even); rows past S
// are not stored.  IEEE expf and division, no fast math; no atomics, so a
// launch is bitwise reproducible.
//
// The bf16 variant (flash_attention_kernel_tc<NQ, NV>): one block per
// (q-tile of 64 rows, head h, batch b): a consumer warpgroup that owns the
// q-tile and a producer warp.  One producer lane brings Q once, then the K
// and V tiles (64 keys) into a ring of two stages, by TMA from the (B, S,
// H, D), (B, T, G, D) and (B, T, G, Dv) layouts at kv head h / (H / G)
// (4-D tensor maps, boxes of 64 dims x 64 rows, 128-byte swizzle, zeros
// past S, T, D and Dv: Q and K are NQ 64-dim halves in shared memory, V
// and the output NV, and the halves past D or Dv are zeros), each stage
// signalled on a "full" mbarrier with its byte count and handed back on an
// "empty" one.  Four (NQ, NV) are compiled, (1, 1), (2, 2), (3, 2) and
// (4, 4); a call takes the first that covers its D and Dv.  At (4, 4) the
// output accumulator is 128 float32 registers a thread and Q plus two K/V
// stages 160 KB of shared memory, so that instantiation runs one block per
// SM (the others two).
// The warpgroup forms S = Q K^T with wgmma (both operands from shared
// memory, exact bf16 x bf16 products, float32 sums), runs the online
// softmax on the accumulator fragments (a row lives in 4 lanes: two xor
// shuffles), and adds P V with wgmma, P from registers, V from shared
// memory (MN-major), NV / 2 products of 128 dims (and one of 64 for an odd
// NV).  P is split into two bf16 terms, P = P_hi + P_lo,
// and both are multiplied into V: one bf16 rounding of P (2^-9 relative)
// breaks the per-element allowance of the plain version by up to 20x on
// short rows (tests/test_torch_flash.py emulates both), the split leaves
// 2^-17.  l sums the float32 P.  The output goes through the Q tile's
// shared memory (NQ or NV halves, whichever is more) to 16-byte stores.
// Needs D % 8 == 0, Dv % 8 == 0 and 16-byte aligned
// tensors (TMA's row strides).  The warpgroup waits for each product:
// overlapping one tile's softmax with the next tile's Q K^T (two score
// arrays in flight) left too few registers, ptxas serialized the wgmma
// pipeline and the kernel took 0.45 ms instead of 0.34 at the OLMo-1B
// shape; two blocks per SM overlap each other's softmax and products.
//
// The float32 variant (flash_attention_kernel_f32): one block per (q-tile
// of 64 rows, h, b); DP is max(D, Dv) rounded up to a power of two from 8
// to 256; each query row belongs to TPR = max(1, DP / 32) adjacent lanes,
// each holding 32 of its DP dims of q and of the output accumulator in
// registers (zeros past D and Dv); K and V tiles of BK keys (32, or 16 at
// DP = 256, so that both stay within 48 KB of static shared memory) are
// staged in shared memory as float32; the BK partial dot products are
// summed across the row's lanes with xor shuffles.  Two blocks per SM are
// asked of the register allocator (__launch_bounds__), one at DP = 256
// (512 threads).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kBQ = 64;   // query rows per block (both variants)
constexpr float kMInit = -1e30f;

struct Shape {
  int B, S, T, H, G, D, Dv, causal, window;   // D: q, k; Dv: v, out
  float scale, cap, inv_cap;   // cap = 0: no softcap
};

// The score of (qpos, kpos) from its raw dot product: scale, softcap,
// mask.
__device__ __forceinline__ float score(float dot, int qpos, int kpos,
                                       const Shape sh, bool mask) {
  float s = dot * sh.scale;
  if (sh.cap > 0.f) s = tanhf(s * sh.inv_cap) * sh.cap;
  if (mask) {
    const bool keep = kpos < sh.T && (!sh.causal || qpos >= kpos) &&
                      (!sh.window || qpos - kpos < sh.window);
    if (!keep) s = __int_as_float(0xff800000);   // -inf
  }
  return s;
}

// The keys any row of the q-tile at q0 keeps, rounded out to whole tiles
// of bk keys: [begin, end).
__device__ __forceinline__ void key_range(const Shape sh, int q0, int bk,
                                          int& begin, int& end) {
  begin = 0;
  end = sh.T;
  if (sh.causal) end = min(sh.T, min(q0 + kBQ, sh.S));
  if (sh.window) begin = max(0, q0 - sh.window + 1) / bk * bk;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBK = 64;         // keys per staged tile
constexpr int kStages = 2;      // K/V ring depth
constexpr int kConsumers = 128; // one warpgroup
constexpr int kThreads = kConsumers + 32;   // + the producer warp
constexpr int kHalf = 64 * 64;  // bf16 of one 64-row x 128-byte block

template <int NQ, int NV>       // 64-dim halves of q, k (NQ) and v, out (NV)
struct Smem {
  // bf16 per tile: Q (later the output), a K stage, a V stage
  static constexpr int kQ = (NQ > NV ? NQ : NV) * kHalf;
  static constexpr int kK = NQ * kHalf;
  static constexpr int kV = NV * kHalf;
  static constexpr int kBytes =
      1024 + (kQ + kStages * (kK + kV)) * 2 + 8 * (1 + 2 * kStages);
  // the (4, 4) accumulator and 160 KB of tiles leave room for one block
  static constexpr int kMinBlocks = NV <= 2 ? 2 : 1;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers and TMA ------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}
// one 64 x 64 box of a (D, heads, rows, B) tensor map at (d0, head, row0, b)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d0, int head,
                                         int row0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(head), "r"(row0),
      "r"(b), "r"(smem_addr(bar))
      : "memory");
}

// -- wgmma ------------------------------------------------------------------

// The shared-memory matrix descriptor of a 128-byte-swizzled operand:
// start address, leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t desc(const void* p, int lbo, int sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int K>
__device__ __forceinline__ void keep(float (&r)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= A B, m64n64k16: A and B from shared memory (descriptors), both
// K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                        uint64_t db, int accum) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accum));
}
// d (+)= A B, m64n64k16: A from registers (the mma.sync A fragment),
// B from shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                        const uint32_t (&a)[4], uint64_t db,
                                        int accum) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accum));
}
// d (+)= A B, m64n128k16: A from registers (the mma.sync A fragment),
// B from shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                        const uint32_t (&a)[4], uint64_t db,
                                        int accum) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accum));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// (x, y) -> the bf16 pair nearest it and the bf16 pair of the remainders
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - __low2float(h), y - __high2float(h));
}
// acc (+)= P V over 16 keys, V at vj: MN-major (rows of keys, 64 dims to a
// swizzled row, the dim halves kHalf apart); the output's halves X, X + 1
// are the 64 consecutive accumulators of one m64n128 product, an odd last
// half those of one m64n64 product
template <int NV, int X = 0>
__device__ __forceinline__ void pv_product(float* acc, const uint32_t (&p)[4],
                                           const __nv_bfloat16* vj) {
  if constexpr (X + 1 < NV) {
    wgmma_rs(*reinterpret_cast<float(*)[64]>(acc + 32 * X), p,
             desc(vj + X * kHalf, 2 * kHalf, 1024), 1);
    pv_product<NV, X + 2>(acc, p, vj);
  } else if constexpr (X < NV) {
    wgmma_rs(*reinterpret_cast<float(*)[32]>(acc + 32 * X), p,
             desc(vj + X * kHalf, 2 * kHalf, 1024), 1);
  }
}

// element (r, c) of a tile stored as 64-dim blocks of 64 rows x 128 bytes,
// 16-byte chunks swizzled by r % 8 (TMA's and wgmma's 128-byte swizzle)
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 6) * kHalf + r * 64 + ((((c & 63) >> 3) ^ (r & 7)) << 3) +
         (c & 7);
}

template <int NQ, int NV>
__global__ void __launch_bounds__(kThreads, (Smem<NQ, NV>::kMinBlocks))
    flash_attention_kernel_tc(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              __nv_bfloat16* __restrict__ o, Shape sh) {
  using L = Smem<NQ, NV>;
  constexpr int NO = 8 * NV;      // 8-dim n-tiles of the output
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* sk = sq + L::kQ;                    // kStages tiles
  __nv_bfloat16* sv = sk + kStages * L::kK;          // kStages tiles
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(sv + kStages * L::kV);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (sh.H / sh.G);
  int k_begin, k_end;
  key_range(sh, q0, kBK, k_begin, k_end);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {   // the producer warp: one lane issues TMA
    if (lane == 0) {
      mbar_expect_tx(q_bar, L::kK * 2);
      for (int x = 0; x < NQ; ++x)
        tma_load(sq + x * kHalf, &tm_q, q_bar, 64 * x, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages, k0 = k_begin + it * kBK;
        if (it >= kStages) mbar_wait(&empty[s], (it / kStages - 1) & 1);
        mbar_expect_tx(&full[s], (L::kK + L::kV) * 2);
        for (int x = 0; x < NQ; ++x)
          tma_load(sk + s * L::kK + x * kHalf, &tm_k, &full[s], 64 * x, g,
                   k0, b);
        for (int x = 0; x < NV; ++x)
          tma_load(sv + s * L::kV + x * kHalf, &tm_v, &full[s], 64 * x, g,
                   k0, b);
      }
    }
    return;
  }

  // the consumer warpgroup: fragment rows lane / 4 (+ 8) of this warp's 16,
  // columns 2 (lane % 4) + {0, 1} of each 8-wide n-tile
  const int row0 = q0 + warp * 16 + (lane >> 2);
  float acc[4 * NO];
#pragma unroll
  for (int i = 0; i < 4 * NO; ++i) acc[i] = 0.f;
  float m_r[2] = {kMInit, kMInit}, l_r[2] = {0.f, 0.f};
  mbar_wait(q_bar, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages, k0 = k_begin + it * kBK;
    const __nv_bfloat16* ks = sk + st * L::kK;
    const __nv_bfloat16* vs = sv + st * L::kV;
    mbar_wait(&full[st], (it / kStages) & 1);

    // S = Q K^T, 64 x 64, k-steps of 16 dims (32 bytes along a swizzled row)
    float s[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NQ; ++kk)
      wgmma_ss(s, desc(sq + (kk >> 2) * kHalf + (kk & 3) * 16, 16, 1024),
               desc(ks + (kk >> 2) * kHalf + (kk & 3) * 16, 16, 1024),
               kk > 0);
    wg_commit();
    wg_wait();
    keep(s);

    // scale, softcap, mask (only tiles that reach past a mask edge)
    const bool edge = k0 + kBK > sh.T || (sh.causal && k0 + kBK - 1 > q0) ||
                      (sh.window && q0 + kBQ - 1 - k0 >= sh.window);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int kpos = k0 + (i >> 2) * 8 + 2 * (lane & 3) + (i & 1);
      s[i] = score(s[i], row0 + ((i >> 1) & 1) * 8, kpos, sh, edge);
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m_r[r] - mx[r]);
      m_r[r] = mx[r];
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = expf(s[i] - mx[(i >> 1) & 1]);
      l_r[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int i = 0; i < 4 * NO; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += (P_hi + P_lo) V; the C fragments of key tiles 2j, 2j + 1 are the
    // A fragment of keys 16 j .. 16 j + 15
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      split_bf16(s[8 * j], s[8 * j + 1], ph[j][0], pl[j][0]);
      split_bf16(s[8 * j + 2], s[8 * j + 3], ph[j][1], pl[j][1]);
      split_bf16(s[8 * j + 4], s[8 * j + 5], ph[j][2], pl[j][2]);
      split_bf16(s[8 * j + 6], s[8 * j + 7], ph[j][3], pl[j][3]);
    }
    wg_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pv_product<NV>(acc, ph[j], vs + j * 16 * 64);
      pv_product<NV>(acc, pl[j], vs + j * 16 * 64);
    }
    wg_commit();
    wg_wait();
    keep(acc);
    mbar_arrive(&empty[st]);
  }

  // l over the row's 4 lanes, then out = acc / l through the Q tile (no
  // longer read once every consumer is past its last wgmma) to 16-byte
  // stores
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    den[r] = fmaxf(l_r[r], 1e-30f);
  }
  const int r0 = warp * 16 + (lane >> 2);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + 2 * (lane & 3);
    *reinterpret_cast<uint32_t*>(sq + swz(r0, c)) =
        pack_bf16(acc[4 * n] / den[0], acc[4 * n + 1] / den[0]);
    *reinterpret_cast<uint32_t*>(sq + swz(r0 + 8, c)) =
        pack_bf16(acc[4 * n + 2] / den[1], acc[4 * n + 3] / den[1]);
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * NO; idx += 32) {
    const int r = warp * 16 + idx / NO, c = idx % NO;
    const int qpos = q0 + r;
    if (qpos >= sh.S || 8 * c >= sh.Dv) continue;
    *reinterpret_cast<uint4*>(o + (((size_t)b * sh.S + qpos) * sh.H + h) *
                                      sh.Dv + 8 * c) =
        *reinterpret_cast<const uint4*>(sq + swz(r, 8 * c));
  }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The (D, heads, rows, B) bf16 tensor x as a TMA map of 64 x 64 boxes
// (64 dims x 64 rows of one head), 128-byte swizzle, zeros out of bounds.
int tensor_map(CUtensorMap* map, const void* x, int D, int heads, int rows,
               int B) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault);
    if (err != cudaSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)rows * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int NQ, int NV>
int launch(const void* q, const void* k, const void* v, void* o,
           const Shape& sh, cudaStream_t st) {
  using L = Smem<NQ, NV>;
  static bool attr_set = false;   // before any graph capture: first call
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel_tc<NQ, NV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  CUtensorMap tq, tk, tv;
  int err = tensor_map(&tq, q, sh.D, sh.H, sh.S, sh.B);
  if (!err) err = tensor_map(&tk, k, sh.D, sh.G, sh.T, sh.B);
  if (!err) err = tensor_map(&tv, v, sh.Dv, sh.G, sh.T, sh.B);
  if (err) return err;
  const dim3 grid((sh.S + kBQ - 1) / kBQ, sh.H, sh.B);
  flash_attention_kernel_tc<NQ, NV><<<grid, kThreads, L::kBytes, st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), sh);
  return static_cast<int>(cudaGetLastError());
}

// The first compiled (NQ, NV) whose halves cover D and Dv; TMA needs
// 16-byte rows and base addresses.
int dispatch(const void* q, const void* k, const void* v, void* o,
             const Shape& sh, cudaStream_t st) {
  if (sh.D % 8 != 0 || sh.Dv % 8 != 0 ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) &
       15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nq = (sh.D + 63) / 64, nv = (sh.Dv + 63) / 64;
  if (nq <= 1 && nv <= 1) return launch<1, 1>(q, k, v, o, sh, st);
  if (nq <= 2 && nv <= 2) return launch<2, 2>(q, k, v, o, sh, st);
  if (nq <= 3 && nv <= 2) return launch<3, 2>(q, k, v, o, sh, st);
  if (nq <= 4 && nv <= 4) return launch<4, 4>(q, k, v, o, sh, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

template <int DP>
struct Layout {
  static constexpr int kTPR = DP >= 32 ? DP / 32 : 1;  // lanes per row
  static constexpr int kDT = DP / kTPR;                // dims per lane
  static constexpr int kNCH = kDT / 4;                 // float4 chunks
  static constexpr int kThreads = kBQ * kTPR;
  // keys per staged tile: K and V tiles within 48 KB of static shared
  // memory
  static constexpr int kBK = DP >= 256 ? 16 : 32;
  static constexpr int kMinBlocks = DP >= 256 ? 1 : 2;
};

template <int DP>
__global__ void __launch_bounds__(Layout<DP>::kThreads,
                                  Layout<DP>::kMinBlocks)
    flash_attention_kernel_f32(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ o, Shape sh) {
  using L = Layout<DP>;
  constexpr int TPR = L::kTPR, DT = L::kDT, NCH = L::kNCH, kBK = L::kBK;
  __shared__ __align__(16) float ks[kBK][DP];
  __shared__ __align__(16) float vs[kBK][DP];

  const int tid = threadIdx.x;
  const int row = tid / TPR, part = tid % TPR;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (sh.H / sh.G);
  const int qpos = q0 + row;
  const bool live = qpos < sh.S;

  // dims c = part + TPR i (float4 chunks), so the TPR lanes of a row read
  // neighbouring banks
  float qr[DT], acc[DT];
  const float* qrow =
      q + (((size_t)b * sh.S + (live ? qpos : 0)) * sh.H + h) * sh.D;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c = part + TPR * i;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * c + e;
      qr[4 * i + e] = (live && d < sh.D) ? qrow[d] : 0.f;
      acc[4 * i + e] = 0.f;
    }
  }
  float m = kMInit, l = 0.f;

  int k_begin, k_end;
  key_range(sh, q0, kBK, k_begin, k_end);

  const size_t k_row = (size_t)sh.G * sh.D, v_row = (size_t)sh.G * sh.Dv;
  const float* kb = k + (size_t)b * sh.T * k_row + (size_t)g * sh.D;
  const float* vb = v + (size_t)b * sh.T * v_row + (size_t)g * sh.Dv;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();
    for (int idx = tid; idx < kBK * DP; idx += L::kThreads) {
      const int j = idx / DP, d = idx % DP;
      const int kp = k0 + j;
      ks[j][d] = kp < sh.T && d < sh.D ? kb[kp * k_row + d] : 0.f;
      vs[j][d] = kp < sh.T && d < sh.Dv ? vb[kp * v_row + d] : 0.f;
    }
    __syncthreads();

    float s[kBK];
#pragma unroll
    for (int j = 0; j < kBK; ++j) s[j] = 0.f;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int c = part + TPR * i;
#pragma unroll
      for (int j = 0; j < kBK; ++j) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][4 * c]);
        s[j] = fmaf(qr[4 * i], kk.x, s[j]);
        s[j] = fmaf(qr[4 * i + 1], kk.y, s[j]);
        s[j] = fmaf(qr[4 * i + 2], kk.z, s[j]);
        s[j] = fmaf(qr[4 * i + 3], kk.w, s[j]);
      }
    }
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1)
        s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
      s[j] = score(s[j], qpos, k0 + j, sh, true);
      m_new = fmaxf(m_new, s[j]);
    }
    const float alpha = expf(m - m_new);
    m = m_new;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < DT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const int c = part + TPR * i;
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][4 * c]);
        acc[4 * i] = fmaf(s[j], vv.x, acc[4 * i]);
        acc[4 * i + 1] = fmaf(s[j], vv.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(s[j], vv.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(s[j], vv.w, acc[4 * i + 3]);
      }
    }
  }

  if (!live) return;
  const float denom = fmaxf(l, 1e-30f);
  float* orow = o + (((size_t)b * sh.S + qpos) * sh.H + h) * sh.Dv;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c = part + TPR * i;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * c + e;
      if (d < sh.Dv) orow[d] = acc[4 * i + e] / denom;
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o,
           const Shape& sh, cudaStream_t st) {
  const dim3 grid((sh.S + kBQ - 1) / kBQ, sh.H, sh.B);
  flash_attention_kernel_f32<DP><<<grid, Layout<DP>::kThreads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sh);
  return static_cast<int>(cudaGetLastError());
}

// max(D, Dv) rounded up to the next compiled width: 8, 16, ..., 256.
int dispatch(const void* q, const void* k, const void* v, void* o,
             const Shape& sh, cudaStream_t st) {
  const int d = sh.D > sh.Dv ? sh.D : sh.Dv;
  if (d <= 8) return launch<8>(q, k, v, o, sh, st);
  if (d <= 16) return launch<16>(q, k, v, o, sh, st);
  if (d <= 32) return launch<32>(q, k, v, o, sh, st);
  if (d <= 64) return launch<64>(q, k, v, o, sh, st);
  if (d <= 128) return launch<128>(q, k, v, o, sh, st);
  if (d <= 256) return launch<256>(q, k, v, o, sh, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace f32

}  // namespace

// q (B, S, H, D), k (B, T, G, D), v (B, T, G, Dv) -> o (B, S, H, Dv);
// softcap: c > 0 applies s = tanh(s / c) c to every scaled score; 0 off.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int T, int H, int G, int D, int Dv,
                                      int causal, int window, int is_bf16,
                                      float softcap, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (G <= 0 || H % G != 0 || D <= 0 || Dv <= 0 || softcap < 0.f)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{B, S, T, H, G, D, Dv, causal, window,
                 static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))),
                 softcap, softcap > 0.f ? 1.0f / softcap : 0.f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? tc::dispatch(q, k, v, o, sh, st)
                 : f32::dispatch(q, k, v, o, sh, st);
}
