// Row gather with an optional second row added: the feature side of a
// coordinate-union sparse add.
//
// Replaces the TPU kernel msmdfusion_tpu/ops/sparse/merge_take.py _kernel
// (wrapper merge_take_rows). On the TPU a row gather retires about one row
// per descriptor, so that kernel exploited the two-run-monotone indices of
// its callers: it DMA'd two sliding windows of the table into VMEM and
// built the rows with one-hot MXU products over a bf16 hi/lo split of the
// table, zeroing (and counting) any row outside its window. On the card a
// gather is a plain coalesced load, so none of that is needed, nothing is
// dropped and the result is exact fp32:
//
//   out[r] = (0 <= idx[r] < n ? table[idx[r]] : 0)
//          + (dup[r] && 0 <= idx2[r] < n ? table[idx2[r]] : 0)
//
// (INT_MAX marks an inactive row.) Two paths, which the wrapper picks by
// shape: where C % 4 == 0 and the table and the output are 16-byte
// aligned, each thread moves one float4 slice of one output row (the
// threads of a warp cover consecutive slices of consecutive rows, so every
// load and store is a full 16-byte access); at any other width or
// alignment each thread moves one element, the same sums in the same
// order.
//
// Bound on the card: bytes (the indices, each gathered row once, the output
// once); there is one add per element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float add(float a, float b) { return a + b; }

// T = float4: one 16-byte slice per thread, vecs = C / 4 slices a row;
// T = float: one element per thread, vecs = C
template <typename T>
__global__ void merge_take_kernel(const T* __restrict__ table, int n,
                                  int vecs, const int32_t* __restrict__ idx,
                                  const int32_t* __restrict__ idx2,
                                  const uint8_t* __restrict__ dup, int m,
                                  T* __restrict__ out) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)m * vecs) return;
  int r = (int)(e / vecs);
  int v = (int)(e - (int64_t)r * vecs);
  int32_t i0 = __ldg(idx + r);
  T acc = (i0 >= 0 && i0 < n) ? __ldg(table + (int64_t)i0 * vecs + v) : T{};
  if (idx2 != nullptr && __ldg(dup + r)) {
    int32_t i1 = __ldg(idx2 + r);
    if (i1 >= 0 && i1 < n)
      acc = add(acc, __ldg(table + (int64_t)i1 * vecs + v));
  }
  out[e] = acc;
}

template <typename T>
void launch(const void* table, int n, int vecs, const void* idx,
            const void* idx2, const void* dup, int m, void* out,
            cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = ((int64_t)m * vecs + threads - 1) / threads;
  merge_take_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      (const T*)table, n, vecs, (const int32_t*)idx, (const int32_t*)idx2,
      (const uint8_t*)dup, m, (T*)out);
}

}  // namespace

// vec4: the float4 path (C % 4 == 0, table and out 16-byte aligned), else
// the per-element one
extern "C" int msmd_merge_take(const void* table, int n, int c,
                               const void* idx, const void* idx2,
                               const void* dup, int m, void* out, int vec4,
                               void* stream) {
  if (m > 0 && c > 0) {
    if (vec4) {
      launch<float4>(table, n, c / 4, idx, idx2, dup, m, out,
                     (cudaStream_t)stream);
    } else {
      launch<float>(table, n, c, idx, idx2, dup, m, out,
                    (cudaStream_t)stream);
    }
  }
  return (int)cudaGetLastError();
}
