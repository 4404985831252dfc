// Rulebook rows of a sparse-conv plan, by binary search: two entry points
// over one device search.
//
// msmd_rows_affine replaces the TPU kernel
// msmdfusion_tpu/ops/sparse/matchconv.py _win_rows_kernel (wrapper
// _win_plan_rows), for plans in affine form (query = okeys[r] + dkey[t]):
// subm and downsample plans.
//
// msmd_rows_queries replaces the TPU kernel _rows_kernel (wrapper
// plan_rows), for plans with explicit queries [K, Ta]: the transpose
// ("dual") plans of the strided convs that the training backward runs on.
//
// Both TPU kernels matched each 128-row output column against a window of
// the sorted input keys held in VMEM, with one-hot compares extracted
// through MXU dots, and could drop a match that fell outside their slab.
// Here every (row, tap) pair is one thread that runs a lower-bound binary
// search over the sorted input keys, so no match is ever dropped:
//
//   rows[r, t] = i  where in_keys[i] == query(r, t), inb[r, t] holds and
//                    the query is a real key (okeys[r] != INT_MAX for the
//                    affine form, queries[r, t] != INT_MAX for the explicit)
//              = -1 otherwise.
//
// Bound on the card: bytes. The work per pair is ~log2(K_in) dependent
// loads from a key array that sits in L2 (K_in * 4 bytes, < 1 MB); the
// least traffic is reading inb and the queries once and writing rows once.
// Taps of one row are neighbouring threads, so their searches share their
// first steps in cache.
//
// Optionally (masks not null, Ta <= 62) each entry point also writes each
// row's tap-hit mask, bit t set where rows[r, t] >= 0: the key by which
// the packed bf16 kernels' row order sorts the rows. The mask is zeroed on
// the stream and every hit ORs its bit in (atomicOr: the result does not
// depend on the order), so the order costs the plan no launch of its own
// beyond the sort.

#include <cuda_runtime.h>
#include <stdint.h>

#include "key_search.cuh"

namespace {

__global__ void rows_affine_kernel(const int32_t* __restrict__ in_keys,
                                   int k_in,
                                   const int32_t* __restrict__ okeys,
                                   int k_out,
                                   const int32_t* __restrict__ dkey, int ta,
                                   const uint8_t* __restrict__ inb,
                                   int32_t* __restrict__ rows,
                                   unsigned long long* __restrict__ masks) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t total = (int64_t)k_out * ta;
  if (idx >= total) return;
  int r = (int)(idx / ta);
  int t = (int)(idx - (int64_t)r * ta);
  int32_t okey = __ldg(okeys + r);
  int32_t result = -1;
  if (okey != INT_MAX_KEY && __ldg(inb + idx)) {
    // an in-bounds tap of a valid row gives a real key in [0, 2^31)
    int32_t q = (int32_t)((uint32_t)okey + (uint32_t)__ldg(dkey + t));
    result = find_key(in_keys, k_in, q);
  }
  rows[idx] = result;
  if (masks != nullptr && result >= 0) atomicOr(masks + r, 1ull << t);
}

__global__ void rows_queries_kernel(const int32_t* __restrict__ in_keys,
                                    int k_in,
                                    const int32_t* __restrict__ queries,
                                    int64_t total, int ta,
                                    const uint8_t* __restrict__ inb,
                                    int32_t* __restrict__ rows,
                                    unsigned long long* __restrict__ masks) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  int32_t q = __ldg(queries + idx);
  int32_t result = (q != INT_MAX_KEY && __ldg(inb + idx))
                       ? find_key(in_keys, k_in, q)
                       : -1;
  rows[idx] = result;
  if (masks != nullptr && result >= 0) {
    int64_t r = idx / ta;
    atomicOr(masks + r, 1ull << (int)(idx - r * ta));
  }
}

constexpr int kThreads = 256;

}  // namespace

extern "C" int msmd_rows_affine(const void* in_keys, int k_in,
                                const void* okeys, int k_out,
                                const void* dkey, int ta, const void* inb,
                                void* rows, void* masks, void* stream) {
  int64_t total = (int64_t)k_out * ta;
  if (masks != nullptr && k_out > 0)
    cudaMemsetAsync(masks, 0, (size_t)k_out * 8, (cudaStream_t)stream);
  if (total > 0) {
    int64_t blocks = (total + kThreads - 1) / kThreads;
    rows_affine_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
        (const int32_t*)in_keys, k_in, (const int32_t*)okeys, k_out,
        (const int32_t*)dkey, ta, (const uint8_t*)inb, (int32_t*)rows,
        (unsigned long long*)masks);
  }
  return (int)cudaGetLastError();
}

extern "C" int msmd_rows_queries(const void* in_keys, int k_in,
                                 const void* queries, int k_rows, int ta,
                                 const void* inb, void* rows, void* masks,
                                 void* stream) {
  int64_t total = (int64_t)k_rows * ta;
  if (masks != nullptr && k_rows > 0)
    cudaMemsetAsync(masks, 0, (size_t)k_rows * 8, (cudaStream_t)stream);
  if (total > 0) {
    int64_t blocks = (total + kThreads - 1) / kThreads;
    rows_queries_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
        (const int32_t*)in_keys, k_in, (const int32_t*)queries, total, ta,
        (const uint8_t*)inb, (int32_t*)rows, (unsigned long long*)masks);
  }
  return (int)cudaGetLastError();
}
