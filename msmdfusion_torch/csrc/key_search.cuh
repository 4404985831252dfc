// Binary search of a query key in a coordinate set's sorted keys: the
// device function shared by the kernels that match sparse-conv queries
// (rows_affine.cu's rulebook rows, match_conv.cu's one-hot conv).

#pragma once

#include <stdint.h>

#define INT_MAX_KEY 2147483647

// the row of q in the ascending keys [k_in], or -1
static __device__ __forceinline__ int32_t find_key(
    const int32_t* __restrict__ keys, int k_in, int32_t q) {
  int lo = 0, hi = k_in;
  while (lo < hi) {
    int mid = lo + ((hi - lo) >> 1);
    if (__ldg(keys + mid) < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return (lo < k_in && __ldg(keys + lo) == q) ? lo : -1;
}
