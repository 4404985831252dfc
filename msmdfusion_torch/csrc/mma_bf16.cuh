// Device helpers of the bf16 tensor-core kernels (sm_80 and later):
// cp.async copies into shared memory, fp32 pairs rounded (or split into
// bf16 hi + lo, the x3 route) into bf16x2 registers, and the m16n8k16 bf16
// tensor-core product with fp32 accumulators.
//
// Fragment layout of mma.sync.m16n8k16 (g = lane / 4, c = lane % 4):
//   A (16 x 16, row-major): a[0] rows g, cols 2c, 2c+1; a[1] rows g+8;
//                           a[2] rows g, cols 2c+8, 2c+9; a[3] rows g+8
//   B (16 x 8):             b[0] k 2c, 2c+1, col g; b[1] k 2c+8, 2c+9
//   C (16 x 8, fp32):       c[0], c[1] row g, cols 2c, 2c+1; c[2], c[3]
//                           row g+8
// The element of the lower index sits in the lower 16 bits of a register.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_bf16 {

// 16 bytes from global to shared memory, or 16 zero bytes where !pred
// (src-size 0: nothing is read)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n));
}

// 4 bytes, or 4 zero bytes where !pred
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// (lo, hi) rounded to bf16 (nearest, ties to even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the x3 split of an fp32 pair (x, y), x in the low half: *h = its bf16
// rounding, *l = the bf16 rounding of what that leaves (x - float(bf16(x)),
// exact in fp32); *h + *l is the pair to ~2^-16 of each value
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t* h,
                                           uint32_t* l) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  const float2 r = __bfloat1622float2(v);
  __nv_bfloat162 w = __floats2bfloat162_rn(x - r.x, y - r.y);
  *h = *reinterpret_cast<uint32_t*>(&v);
  *l = *reinterpret_cast<uint32_t*>(&w);
}

// c += a @ b on one m16n8k16 tile
__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace mma_bf16
