// Device code the two neighbor-list builds share (nlist_build.cu,
// cell_build.cu): the pair distance as PyTorch's separate elementwise ops
// form it, and the copy of a kept list.
#pragma once
#include <stddef.h>
#include <stdint.h>

// r2 = dx*dx + dy*dy + dz*dz without FMA contraction, so a kernel's
// distance test equals its plain version's bit for bit.
__device__ __forceinline__ float r2_unfused(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// n 32-bit words src -> dst, threads tid, tid + stride, ...: 16-byte
// vectors between a scalar head and a scalar tail (all scalar if src and
// dst are not aligned alike).
__device__ __forceinline__ void copy_words(const uint32_t* __restrict__ src,
                                           uint32_t* __restrict__ dst,
                                           size_t n, size_t tid,
                                           size_t stride) {
  size_t head = ((16u - (reinterpret_cast<uintptr_t>(dst) & 15u)) & 15u) / 4;
  if ((reinterpret_cast<uintptr_t>(src) ^ reinterpret_cast<uintptr_t>(dst)) &
      15u)
    head = n;
  if (head > n) head = n;
  for (size_t k = tid; k < head; k += stride) dst[k] = src[k];
  const size_t n4 = (n - head) / 4;
  const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (size_t k = tid; k < n4; k += stride) d4[k] = s4[k];
  for (size_t k = head + 4 * n4 + tid; k < n; k += stride) dst[k] = src[k];
}
