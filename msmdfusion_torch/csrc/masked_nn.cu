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
// Bound on the card: fp32 operations, 8 a pair (3 multiplies and 2 adds for
// the dot, 1 multiply and 2 adds for the distance); the bytes (inputs once,
// two [Na] outputs) are negligible beside them. The contract forbids fused
// multiply-adds, so these issue one a lane-cycle: half the 67 TFLOP/s that
// counts an FMA as two, which sets the floor; each pair also costs a
// clamp, the batch-id and distance compares and two selects.
//
// Design: each thread holds RPT = 8 rows of A in registers (a block 2048),
// so one staged row of B serves 8 pairs. A block stages up to 1024 rows of
// B at a time, keeping only the valid ones, compacted in index order by
// warp ballots: one 16-byte record (x, y, z, |b|^2) and one 8-byte record
// (j, batch id) each, read by every thread as a broadcast. The pair loop
// has no branch: the batch id and the strict '<' in ascending j (the first
// of equal minima) are predicated selects, and where every staged row and
// every row of a warp share one batch id (a batch of one), the warp skips
// the id compares. The arithmetic is the plain
// version's, operation by operation, with explicit round-to-nearest
// intrinsics so that nothing is fused: the kernel, the plain PyTorch
// version and the JAX reference agree bit for bit (on voxel-index
// coordinates every intermediate is an integer below 2^24, so all three
// are exact there).
//
// One side of the GMA search has only 2048 rows of A (the
// representatives, one block of rows), the other ~160k rows of A against
// 2048 of B, so B is split across the grid's y dimension until the grid
// holds ~8 blocks per SM. The splits meet in one 64-bit atomicMin per row
// on (float bits of d2 << 32 | j): a non-negative float orders like its
// bits, and the low word breaks ties towards the lowest j.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int RPT = 8;                       // rows of A per thread
constexpr int ROWS = THREADS * RPT;          // rows of A per block
constexpr int TILE = 1024;                   // rows of B staged per pass
constexpr int GROUPS = TILE / THREADS;       // 32-row groups per warp
constexpr int MIN_CHUNK = 64;                // rows of B per block, least
constexpr int SMS = 132;                     // an H100's, for the split
constexpr unsigned long long EMPTY = ~0ull;  // above every (d2, j) key

// the rows of A of one thread against the n staged rows of B, in index
// order; CHECK_ID: each pair also compares the batch ids (not where every
// staged row and every live row of A share one id)
template <bool CHECK_ID>
__device__ __forceinline__ void scan(const float4* s_b, const int2* s_jid,
                                     int n, const float* ax, const float* ay,
                                     const float* az, const float* a2,
                                     const int32_t* aid, float* best_d,
                                     int32_t* best_j) {
#pragma unroll 2
  for (int k = 0; k < n; ++k) {
    const float4 p = s_b[k];
    const int2 jid = s_jid[k];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float prod = __fadd_rn(__fadd_rn(__fmul_rn(ax[r], p.x),
                                             __fmul_rn(ay[r], p.y)),
                                   __fmul_rn(az[r], p.z));
      float d = __fsub_rn(__fadd_rn(a2[r], p.w), __fmul_rn(2.f, prod));
      d = d > 0.f ? d : 0.f;       // also turns -0 into +0
      const bool better =
          CHECK_ID ? (jid.y == aid[r]) & (d < best_d[r]) : d < best_d[r];
      best_d[r] = better ? d : best_d[r];
      best_j[r] = better ? jid.x : best_j[r];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
masked_nn_kernel(const float* __restrict__ a, const int32_t* __restrict__ ab,
                 int na, const float* __restrict__ b,
                 const int32_t* __restrict__ bb,
                 const uint8_t* __restrict__ b_valid, int nb, int chunk,
                 unsigned long long* __restrict__ best) {
  __shared__ float4 s_b[TILE];      // x, y, z, |b|^2 of the valid rows
  __shared__ int2 s_jid[TILE];      // their j and batch id
  __shared__ int s_cnt[THREADS / 32];
  __shared__ int s_idmin[THREADS / 32], s_idmax[THREADS / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float ax[RPT], ay[RPT], az[RPT], a2[RPT], best_d[RPT];
  int32_t aid[RPT], best_j[RPT];
  bool live[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int i = blockIdx.x * ROWS + r * THREADS + tid;
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
    // stage the tile's valid rows in index order: warp w takes rows
    // t0 + w * 128 + [0, 128), 32 per group
    float4 rec[GROUPS];
    int32_t id[GROUPS];
    unsigned mask[GROUPS];
    int count = 0, lo = INT32_MAX, hi = INT32_MIN;
#pragma unroll
    for (int q = 0; q < GROUPS; ++q) {
      const int j = t0 + (warp * GROUPS + q) * 32 + lane;
      const bool ok = j < j_end && __ldg(b_valid + j);
      float bx = 0.f, by = 0.f, bz = 0.f;
      id[q] = 0;
      if (ok) {
        bx = __ldg(b + 3 * (int64_t)j);
        by = __ldg(b + 3 * (int64_t)j + 1);
        bz = __ldg(b + 3 * (int64_t)j + 2);
        id[q] = __ldg(bb + j);
      }
      rec[q] = make_float4(bx, by, bz,
                           __fadd_rn(__fadd_rn(__fmul_rn(bx, bx),
                                               __fmul_rn(by, by)),
                                     __fmul_rn(bz, bz)));
      mask[q] = __ballot_sync(0xffffffffu, ok);
      count += __popc(mask[q]);
      lo = ok ? min(lo, id[q]) : lo;
      hi = ok ? max(hi, id[q]) : hi;
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    __syncthreads();               // the last tile's records are read
    if (lane == 0) {
      s_cnt[warp] = count;
      s_idmin[warp] = lo;
      s_idmax[warp] = hi;
    }
    __syncthreads();
    int slot = 0, n = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      const int c = s_cnt[w];
      slot += w < warp ? c : 0;
      n += c;
      lo = min(lo, s_idmin[w]);
      hi = max(hi, s_idmax[w]);
    }
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int q = 0; q < GROUPS; ++q) {
      if (mask[q] >> lane & 1u) {
        const int k = slot + __popc(mask[q] & below);
        s_b[k] = rec[q];
        s_jid[k] = make_int2(t0 + (warp * GROUPS + q) * 32 + lane, id[q]);
      }
      slot += __popc(mask[q]);
    }
    __syncthreads();

    // one batch id in the staged rows (lo == hi): a warp whose live rows
    // all have it skips the compares, one whose rows have none skips the
    // tile
    bool all_in = true, none_in = true;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      all_in &= !live[r] || aid[r] == lo;
      none_in &= !live[r] || aid[r] != lo;
    }
    const bool one_id = lo == hi;
    if (one_id && __all_sync(0xffffffffu, none_in)) continue;
    if (one_id && __all_sync(0xffffffffu, all_in))
      scan<false>(s_b, s_jid, n, ax, ay, az, a2, aid, best_d, best_j);
    else
      scan<true>(s_b, s_jid, n, ax, ay, az, a2, aid, best_d, best_j);
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int i = blockIdx.x * ROWS + r * THREADS + tid;
    if (i >= na || best_j[r] < 0) continue;
    const unsigned long long key =
        ((unsigned long long)__float_as_uint(best_d[r]) << 32) |
        (unsigned)best_j[r];
    // the keys only fall: a key not below a value read once is not below
    // the row's minimum, and needs no atomic (most splits' keys, where
    // every block holds the same 2048 rows of A)
    if (key < __ldcg(best + i)) atomicMin(best + i, key);
  }
}

__global__ void finish_kernel(const unsigned long long* __restrict__ best,
                              int na, int32_t* __restrict__ idx,
                              float* __restrict__ d2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= na) return;
  const unsigned long long v = best[i];
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
  cudaMemsetAsync(best, 0xff, (size_t)na * sizeof(unsigned long long), s);
  if (nb > 0) {
    const int gx = (na + ROWS - 1) / ROWS;
    // split B until the grid holds ~8 blocks per SM, each block at least
    // MIN_CHUNK rows of B
    const int want = (8 * SMS + gx - 1) / gx;
    const int max_split = (nb + MIN_CHUNK - 1) / MIN_CHUNK;
    const int split = want < max_split ? want : max_split;
    const int chunk = (nb + split - 1) / split;
    dim3 grid(gx, (nb + chunk - 1) / chunk);
    masked_nn_kernel<<<grid, THREADS, 0, s>>>(
        (const float*)a, (const int32_t*)ab, na, (const float*)b,
        (const int32_t*)bb, (const uint8_t*)b_valid, nb, chunk, best);
  }
  const int flat_blocks = (na + THREADS - 1) / THREADS;
  finish_kernel<<<flat_blocks, THREADS, 0, s>>>(best, na, (int32_t*)idx,
                                                (float*)d2);
  return (int)cudaGetLastError();
}
