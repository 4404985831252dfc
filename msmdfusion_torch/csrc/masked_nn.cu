// Masked nearest neighbour: for every row of A, the nearest valid row of B
// in the same batch, fp32 squared distance, ties to the lowest index.
//
// Replaces the TPU kernel msmdfusion_tpu/ops/nn_argmin.py _nn_kernel
// (wrapper masked_nn). That kernel gave each 256-row tile of A the whole of
// B in VMEM and walked it in 2048-lane chunks, one MXU dot per chunk, so
// the [Na, Nb] distance matrix never reached HBM. Here too nothing of that
// matrix is stored:
//
//   d(i, j) = max(|a_i|^2 + |b_j|^2 - 2 a_i.b_j, 0)
//             over j with b_valid[j] and bb[j] == ab[i]
//   idx[i] = the least j of min_j d(i, j), d2[i] = that minimum
//   no candidate: idx = -1, d2 = +inf
//
// Each thread holds RPT rows of A in registers; a block stages TILE rows of
// B (x, y, z, |b|^2, batch id, valid) in shared memory and every thread
// scans them in ascending index order with a strict '<', so a thread keeps
// the first of equal minima. One side of the GMA search has only 2048 rows
// of A (the representatives), which alone would fill a handful of the 132
// SMs, so B is split across the grid's y dimension as well. The partial
// results of the splits meet in one 64-bit atomicMin per row on
// (float bits of d2 << 32 | j): a non-negative float orders like its bits,
// and the low word breaks ties towards the lowest j.
//
// The arithmetic is the plain version's, operation by operation, with
// explicit round-to-nearest intrinsics so that no multiply-add is fused:
// the kernel, the plain PyTorch version and the JAX reference agree bit
// for bit (on voxel-index coordinates every intermediate is an integer
// below 2^24, so all three are exact there).
//
// Bound on the card: fp32 operations, 8 a pair (3 multiplies and 2 adds for
// the dot, 1 multiply and 2 adds for the distance); the bytes (inputs once,
// two [Na] outputs) are negligible beside them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int RPT = 2;          // rows of A per thread
constexpr int TILE = 1024;      // rows of B staged per pass
constexpr unsigned long long EMPTY =
    (0x7f800000ull << 32) | 0xffffffffull;   // (+inf, 0xffffffff)

__global__ void init_kernel(unsigned long long* best, int na) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < na) best[i] = EMPTY;
}

__global__ void __launch_bounds__(THREADS)
masked_nn_kernel(const float* __restrict__ a, const int32_t* __restrict__ ab,
                 int na, const float* __restrict__ b,
                 const int32_t* __restrict__ bb,
                 const uint8_t* __restrict__ b_valid, int nb, int chunk,
                 unsigned long long* __restrict__ best) {
  __shared__ float4 s_b[TILE];      // x, y, z, |b|^2
  __shared__ int32_t s_id[TILE];    // batch id
  __shared__ uint8_t s_ok[TILE];    // valid

  float ax[RPT], ay[RPT], az[RPT], a2[RPT], best_d[RPT];
  int32_t aid[RPT], best_j[RPT];
  bool live[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    int i = (blockIdx.x * RPT + r) * THREADS + threadIdx.x;
    live[r] = i < na;
    ax[r] = live[r] ? __ldg(a + 3 * (int64_t)i) : 0.f;
    ay[r] = live[r] ? __ldg(a + 3 * (int64_t)i + 1) : 0.f;
    az[r] = live[r] ? __ldg(a + 3 * (int64_t)i + 2) : 0.f;
    aid[r] = live[r] ? __ldg(ab + i) : 0;
    a2[r] = __fadd_rn(__fadd_rn(__fmul_rn(ax[r], ax[r]),
                                __fmul_rn(ay[r], ay[r])),
                      __fmul_rn(az[r], az[r]));
    best_d[r] = __int_as_float(0x7f800000);
    best_j[r] = -1;
  }

  const int j_begin = blockIdx.y * chunk;
  const int j_end = min(nb, j_begin + chunk);
  for (int t0 = j_begin; t0 < j_end; t0 += TILE) {
    const int n = min(TILE, j_end - t0);
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += THREADS) {
      int64_t j = t0 + k;
      float bx = __ldg(b + 3 * j), by = __ldg(b + 3 * j + 1),
            bz = __ldg(b + 3 * j + 2);
      float b2 = __fadd_rn(__fadd_rn(__fmul_rn(bx, bx), __fmul_rn(by, by)),
                           __fmul_rn(bz, bz));
      s_b[k] = make_float4(bx, by, bz, b2);
      s_id[k] = __ldg(bb + j);
      s_ok[k] = __ldg(b_valid + j);
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float4 p = s_b[k];
      const int32_t id = s_id[k];
      if (!s_ok[k]) continue;
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        if (id != aid[r]) continue;
        float prod = __fadd_rn(__fadd_rn(__fmul_rn(ax[r], p.x),
                                         __fmul_rn(ay[r], p.y)),
                               __fmul_rn(az[r], p.z));
        float d = __fsub_rn(__fadd_rn(a2[r], p.w), __fmul_rn(2.f, prod));
        d = d > 0.f ? d : 0.f;        // also turns -0 into +0
        if (d < best_d[r]) {
          best_d[r] = d;
          best_j[r] = t0 + k;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    if (!live[r] || best_j[r] < 0) continue;
    int i = (blockIdx.x * RPT + r) * THREADS + threadIdx.x;
    unsigned long long key =
        ((unsigned long long)__float_as_uint(best_d[r]) << 32) |
        (unsigned)best_j[r];
    atomicMin(best + i, key);
  }
}

__global__ void finish_kernel(const unsigned long long* __restrict__ best,
                              int na, int32_t* __restrict__ idx,
                              float* __restrict__ d2) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= na) return;
  unsigned long long v = best[i];
  if (v == EMPTY) {
    idx[i] = -1;
    d2[i] = __int_as_float(0x7f800000);
  } else {
    idx[i] = (int32_t)(uint32_t)(v & 0xffffffffull);
    d2[i] = __uint_as_float((uint32_t)(v >> 32));
  }
}

}  // namespace

extern "C" int msmd_masked_nn(const void* a, const void* ab, int na,
                              const void* b, const void* bb,
                              const void* b_valid, int nb, void* scratch,
                              void* idx, void* d2, void* stream) {
  if (na <= 0) return (int)cudaGetLastError();
  auto s = (cudaStream_t)stream;
  auto best = (unsigned long long*)scratch;
  const int flat_blocks = (na + THREADS - 1) / THREADS;
  init_kernel<<<flat_blocks, THREADS, 0, s>>>(best, na);
  if (nb > 0) {
    const int gx = (na + THREADS * RPT - 1) / (THREADS * RPT);
    // split B until the grid holds ~4 blocks per SM, keeping at least one
    // full tile of B per block
    const int want = (4 * 132 + gx - 1) / gx;
    const int max_split = (nb + TILE - 1) / TILE;
    const int split = want < max_split ? want : max_split;
    const int chunk = (nb + split - 1) / split;
    dim3 grid(gx, (nb + chunk - 1) / chunk);
    masked_nn_kernel<<<grid, THREADS, 0, s>>>(
        (const float*)a, (const int32_t*)ab, na, (const float*)b,
        (const int32_t*)bb, (const uint8_t*)b_valid, nb, chunk, best);
  }
  finish_kernel<<<flat_blocks, THREADS, 0, s>>>(best, na, (int32_t*)idx,
                                                (float*)d2);
  return (int)cudaGetLastError();
}
