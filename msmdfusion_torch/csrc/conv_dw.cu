// Weight gradient of the gather-GEMM sparse convolution, exact fp32
// (FFMA: fp32 products and sums, no TF32, no bf16 split), with a
// deterministic reduction over the rulebook's rows.
//
// Replaces the with_dw accumulator of the TPU kernel
// msmdfusion_tpu/ops/sparse/matchconv.py _vgather_kernel (the dw scratch
// that _pallas_bwd reads), and the _dw_from_rows einsum it falls back to
// (an XLA HIGHEST einsum, the one-hot engine's dw):
//
//   dw[t] = sum_o feats[rows[o, t]]^T (x) g[o]      rows[o, t] = -1: miss
//
// dw [Ta, Cin, Cout]; feats [K_in, Cin]; rows [K_out, Ta] (the forward
// rulebook); g [K_out, Cout], the gradient of the conv's output. The TPU
// kernel carried the dw sum in VMEM scratch across its sequential grid.
// Here blocks own chunks of the output rows and write per-chunk partials.
//
// Both designs multiply hits only, found on the device (no host sync, no
// pair lists): a warp ballots 32 of a tap's rows and keeps the hitting
// ones, in ascending row order.
//
// Narrow convs (Cin and Cout <= 32: the encoder's first stages, ~166k rows
// x 27 taps at 16 x 16), row streaming. A block owns a chunk of rows and
// a group of up to 9 taps, one warp per tap. Per 32-row step it stages
// rows[o, group] (contiguous in each row; read one step ahead) and g[o]
// once for all its taps; each warp ballots its tap's hits, gathers only
// their feature rows (both by cp.async, together), and each lane adds
// their outer products with g to its (Cin / 4) x (Cout / 8) slice of the
// tap's partial (widths padded to 8, 16 or 32), kept in registers over
// the whole chunk.
//
// Wide convs: a split-K FFMA GEMM over each tap's hits. A block owns one
// tap, one BM x BN tile of (Cin, Cout) (each width cut into the fewest
// tiles of at most 128, multiples of 8: 192 as 2 x 96, 80 and 96 whole)
// and one chunk of rows. Per 2048-row segment it compacts the tap's hits
// into a shared list (ballots, one scan over the 64 warps' counts), then
// walks the list 16 hits a stage: 16-byte cp.async gathers of feats[row]
// and g[o] (4-byte where a width is not a multiple of 4) into a ring of 3
// stages, so the next two stages' gathers overlap this stage's FFMAs (one
// barrier a stage). Each thread holds a TM x 8 register tile (TM 8 where
// the tile has 8192 elements or more, else 4), its rows and columns in
// two halves of the tile so that the shared loads of a warp are
// conflict-free. Blocks differ in work by
// their tap's hits: a submanifold plan's centre tap hits every row, the
// others a fifth to a third. So the chunks are small (~12 blocks per SM)
// and the centre tap's blocks (odd Ta) are issued first, where they do
// not trail the others.
//
// Determinism: each element sums its chunk's hits in ascending row order;
// the per-chunk partials [n_chunks, Ta, Cin, Cout] are then summed by a
// second kernel in a fixed order (consecutive ranges of chunks, each in
// order, then the ranges in order). The launch (tiles, taps per block,
// chunks) is a function of the shapes only (the wrapper's
// conv_dw_launch), so two calls give the same bits; no float atomics. With
// one chunk the first kernel writes dw itself.
//
// Bound on the card: 2 * hits * Cin * Cout FLOP at the fp32 FFMA rate
// against (K_in * Cin + K_out * Ta + K_out * Cout + Ta * Cin * Cout) * 4
// bytes: the narrow convs are bound by bytes, the wide ones by operations.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using mma_bf16::cp_async16;
using mma_bf16::cp_async4;
using mma_bf16::cp_async_commit;
using mma_bf16::cp_async_wait;

constexpr int NR = 32;           // rows per step of the narrow design
constexpr int MAX_G = 9;         // taps per block of the narrow design
constexpr int SEG = 2048;        // rows compacted per pass, wide design
constexpr int BK = 16;           // hits per stage of the wide design
constexpr int NS = 3;            // stages in its ring
constexpr int MAX_TILE = 128;    // tile edge of the wide design

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      v[i] = x.x, v[i + 1] = x.y, v[i + 2] = x.z, v[i + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

// narrow: CI x CO (8, 16 or 32 each) covers Cin x Cout; VEC: 16-byte
// copies (Cin and Cout multiples of 4, aligned rows). The block has one
// warp per tap of its group, so each thread stages one (row, tap) of a
// step, and loads the next step's while this one's gathers run.
template <int CI, int CO, bool VEC>
__global__ void __launch_bounds__(32 * MAX_G)
conv_dw_narrow(const float* __restrict__ feats, int cin,
               const int32_t* __restrict__ rows, int k_out, int ta,
               const float* __restrict__ g, int cout, int taps,
               int chunk_rows, float* __restrict__ out) {
  constexpr int TM = CI / 4, TN = CO / 8;
  constexpr int V = VEC ? 4 : 1;
  __shared__ int s_rows[NR * MAX_G];                 // [k][tap in group]
  __shared__ __align__(16) float s_g[NR * CO];       // [k][Cout]
  __shared__ __align__(16) float s_f[MAX_G * NR * CI];   // per warp: hits
  __shared__ int s_hit[MAX_G * NR];                  // per warp: their k

  const int tid = threadIdx.x, nt = blockDim.x;      // nt = 32 * taps
  const int w = tid >> 5, lane = tid & 31;
  const int t0 = blockIdx.x * taps;                  // groups interleaved
  const int t = t0 + w;
  const int ly = lane >> 3, lx = lane & 7;
  const int o_begin = blockIdx.y * chunk_rows;
  const int o_end = min(k_out, o_begin + chunk_rows);
  float* f_w = s_f + w * NR * CI;
  int* hit_w = s_hit + w * NR;
  // this thread's (row, tap) of each step
  const int k_own = tid / taps, u_own = tid - k_own * taps;
  const bool tap_own = t0 + u_own < ta;
  auto row_of = [&](int o0) {
    const int o = o0 + k_own;
    return o < o_end && tap_own ? __ldg(rows + (int64_t)o * ta + t0 + u_own)
                                : -1;
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  int next = o_begin < o_end ? row_of(o_begin) : -1;
  for (int o0 = o_begin; o0 < o_end; o0 += NR) {
    __syncthreads();               // the last step's staging is read
    s_rows[k_own * MAX_G + u_own] = next;
    if (o0 + NR < o_end) next = row_of(o0 + NR);
    for (int e = tid; e < NR * CO / V; e += nt) {
      const int k = e / (CO / V), c = (e - k * (CO / V)) * V;
      const int o = o0 + k;
      const bool ok = o < o_end && c < cout;
      const float* src = ok ? g + (int64_t)o * cout + c : g;
      if constexpr (VEC)
        cp_async16(s_g + k * CO + c, src, ok);
      else
        cp_async4(s_g + k * CO + c, src, ok);
    }
    cp_async_commit();
    __syncthreads();
    int n = 0;
    if (t < ta) {                                    // warp-uniform
      const int r = s_rows[lane * MAX_G + w];
      const unsigned m = __ballot_sync(0xffffffffu, r >= 0);
      n = __popc(m);
      if (r >= 0) hit_w[__popc(m & ((1u << lane) - 1u))] = lane;
      __syncwarp();
      constexpr int PER = CI / V;                    // copies per row
      for (int q = lane; q < n * PER; q += 32) {
        const int i = q / PER, c = (q - i * PER) * V;
        const int rr = s_rows[hit_w[i] * MAX_G + w];
        const bool ok = c < cin;
        const float* src = ok ? feats + (int64_t)rr * cin + c : feats;
        if constexpr (VEC)
          cp_async16(f_w + i * CI + c, src, ok);
        else
          cp_async4(f_w + i * CI + c, src, ok);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();               // every thread's g and this warp's rows
    for (int i = 0; i < n; ++i) {
      float a[TM], b[TN];
      load_vec<TM>(f_w + i * CI + ly * TM, a);
      load_vec<TN>(s_g + hit_w[i] * CO + lx * TN, b);
#pragma unroll
      for (int x = 0; x < TM; ++x)
#pragma unroll
        for (int y = 0; y < TN; ++y) acc[x][y] = fmaf(a[x], b[y], acc[x][y]);
    }
  }

  if (t >= ta) return;
  // out is [n_chunks, Ta, Cin, Cout]; with one chunk, dw itself
  float* dst = out + ((int64_t)blockIdx.y * ta + t) * cin * cout;
#pragma unroll
  for (int x = 0; x < TM; ++x) {
    const int mi = ly * TM + x;
    if (mi >= cin) continue;
#pragma unroll
    for (int y = 0; y < TN; ++y) {
      const int ni = lx * TN + y;
      if (ni < cout) dst[(int64_t)mi * cout + ni] = acc[x][y];
    }
  }
}

// wide: one tap, one bm x bn tile, one chunk per block; TM x 8 per thread;
// dynamic shared memory: the ring of NS stages, [NS][BK][bm] of feature
// rows, then [NS][BK][bn] of gradient rows
template <int TM, bool VEC>
__global__ void __launch_bounds__(256, 2)
conv_dw_wide(const float* __restrict__ feats, int cin,
             const int32_t* __restrict__ rows, int k_out, int ta,
             const float* __restrict__ g, int cout, int bm, int bn,
             int chunk_rows, float* __restrict__ out) {
  constexpr int TN = 8;
  __shared__ int s_raw[SEG];                  // rows[o, t] of the segment
  __shared__ uint16_t s_hit[SEG];             // the hits' offsets, ascending
  __shared__ int s_cnt[SEG / 32];             // hits per 32 rows, then offsets
  __shared__ int s_total;
  extern __shared__ __align__(16) float ring[];
  float* const As = ring;
  float* const Bs = ring + NS * BK * bm;

  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int tx_n = bn / TN;
  const bool computes = tid < (bm / TM) * tx_n;
  const int tx = tid % tx_n, ty = tid / tx_n;
  // the thread's rows of the tile: am0 + [0, 4) and, for TM 8, am1 +
  // [0, 4); its columns bn0 + [0, 4) and bn1 + [0, 4)
  const int am0 = ty * 4, am1 = bm / 2 + ty * 4;
  const int bn0 = tx * 4, bn1 = bn / 2 + tx * 4;
  // block -> (tile, chunk, tap), the tile fastest; the blocks of the
  // centre tap (odd Ta) first: a submanifold plan's centre tap hits every
  // row, the others a fifth to a third, so its blocks are the longest and
  // must not start last; then chunk by chunk
  const int tiles_m = (cin + bm - 1) / bm;
  const int tiles = tiles_m * ((cout + bn - 1) / bn);
  const int tile = blockIdx.x % tiles, q = blockIdx.x / tiles;
  const int n_chunks = gridDim.x / tiles / ta;
  const int centre = ta % 2 ? ta / 2 : -1;
  int chunk, t;
  if (centre < 0) {
    chunk = q / ta;
    t = q - chunk * ta;
  } else if (q < n_chunks) {
    chunk = q;
    t = centre;
  } else {
    chunk = (q - n_chunks) / (ta - 1);
    t = q - n_chunks - chunk * (ta - 1);
    t += t >= centre;
  }
  const int m0 = tile % tiles_m * bm, n0 = tile / tiles_m * bn;
  const int o_begin = chunk * chunk_rows;
  const int o_end = min(k_out, o_begin + chunk_rows);
  constexpr int V = VEC ? 4 : 1;
  // staging copies of a stage: the block's threads in rows of per_*
  // copies, thread tid copying column c_* of rows k_*, k_* + step_*, ...
  // (a thread past the last whole row of threads copies none); where a
  // staged row has more copies than the block has threads (4-byte copies
  // of a wide tile), copy e of the stage goes to thread e % nt
  const int per_m = bm / V, per_n = bn / V;  // copies per staged row
  const bool rows_m = nt >= per_m, rows_n = nt >= per_n;
  const int step_m = rows_m ? nt / per_m : 0, step_n = rows_n ? nt / per_n : 0;
  const int c_m = tid % per_m * V, c_n = tid % per_n * V;
  const int k_m = rows_m ? tid / per_m : 0, k_n = rows_n ? tid / per_n : 0;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int s0 = o_begin; s0 < o_end; s0 += SEG) {
    const int seg_n = min(SEG, o_end - s0);
    __syncthreads();               // the last segment's list is read
#pragma unroll 4
    for (int k = tid; k < SEG; k += nt)
      s_raw[k] = k < seg_n ? __ldg(rows + (int64_t)(s0 + k) * ta + t) : -1;
    __syncthreads();
    for (int q = warp; q < SEG / 32; q += nw) {
      const unsigned m = __ballot_sync(0xffffffffu, s_raw[q * 32 + lane] >= 0);
      if (lane == 0) s_cnt[q] = __popc(m);
    }
    __syncthreads();
    if (warp == 0) {               // exclusive scan of the 64 counts
      const int c0 = s_cnt[2 * lane], c1 = s_cnt[2 * lane + 1];
      int incl = c0 + c1;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
      }
      const int excl = incl - c0 - c1;
      s_cnt[2 * lane] = excl;
      s_cnt[2 * lane + 1] = excl + c0;
      if (lane == 31) s_total = incl;
    }
    __syncthreads();
    for (int q = warp; q < SEG / 32; q += nw) {
      const bool hit = s_raw[q * 32 + lane] >= 0;
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (hit)
        s_hit[s_cnt[q] + __popc(m & ((1u << lane) - 1u))] =
            (uint16_t)(q * 32 + lane);
    }
    __syncthreads();
    const int n = s_total;
    const int steps = (n + BK - 1) / BK;

    // stage s of the list into buffer b: BK hits' feature rows (the
    // tile's Cin columns) and gradient rows (its Cout columns)
    auto copy_a = [&](int s, int b, int kk, int c) {
      const int i = s * BK + kk;
      const bool ok = i < n && m0 + c < cin;
      const float* src =
          ok ? feats + (int64_t)s_raw[s_hit[i]] * cin + m0 + c : feats;
      if constexpr (VEC)
        cp_async16(As + (b * BK + kk) * bm + c, src, ok);
      else
        cp_async4(As + (b * BK + kk) * bm + c, src, ok);
    };
    auto copy_b = [&](int s, int b, int kk, int c) {
      const int i = s * BK + kk;
      const bool ok = i < n && n0 + c < cout;
      const float* src = ok ? g + (int64_t)(s0 + s_hit[i]) * cout + n0 + c : g;
      if constexpr (VEC)
        cp_async16(Bs + (b * BK + kk) * bn + c, src, ok);
      else
        cp_async4(Bs + (b * BK + kk) * bn + c, src, ok);
    };
    auto stage = [&](int s, int b) {
      if (rows_m) {
        for (int kk = k_m; kk < BK && step_m; kk += step_m)
          if (tid < step_m * per_m) copy_a(s, b, kk, c_m);
      } else {
        for (int e = tid; e < BK * per_m; e += nt)
          copy_a(s, b, e / per_m, e % per_m * V);
      }
      if (rows_n) {
        for (int kk = k_n; kk < BK && step_n; kk += step_n)
          if (tid < step_n * per_n) copy_b(s, b, kk, c_n);
      } else {
        for (int e = tid; e < BK * per_n; e += nt)
          copy_b(s, b, e / per_n, e % per_n * V);
      }
    };

    // the ring: stages s + 1 and s + 2 in flight while stage s is
    // multiplied; one group committed per stage slot, empty past the end
#pragma unroll
    for (int p = 0; p < NS - 1; ++p) {
      if (p < steps) stage(p, p);
      cp_async_commit();
    }
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<NS - 2>();     // this thread's copies of stage s
      __syncthreads();             // everyone's; stage s - 1 is multiplied
      if (s + NS - 1 < steps) stage(s + NS - 1, (s + NS - 1) % NS);
      cp_async_commit();
      if (computes) {
        const float* as = As + (s % NS) * BK * bm;
        const float* bs = Bs + (s % NS) * BK * bn;
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          float a[TM], b[TN];
          load_vec<4>(as + kk * bm + am0, a);
          if constexpr (TM == 8) load_vec<4>(as + kk * bm + am1, a + 4);
          load_vec<4>(bs + kk * bn + bn0, b);
          load_vec<4>(bs + kk * bn + bn1, b + 4);
#pragma unroll
          for (int x = 0; x < TM; ++x)
#pragma unroll
            for (int y = 0; y < TN; ++y)
              acc[x][y] = fmaf(a[x], b[y], acc[x][y]);
        }
      }
    }
  }

  if (!computes) return;
  float* dst = out + ((int64_t)chunk * ta + t) * cin * cout;
#pragma unroll
  for (int x = 0; x < TM; ++x) {
    const int mi = m0 + (x < 4 ? am0 + x : am1 + x - 4);
    if (mi >= cin) continue;
#pragma unroll
    for (int y = 0; y < TN; ++y) {
      const int ni = n0 + (y < 4 ? bn0 + y : bn1 + y - 4);
      if (ni < cout) dst[(int64_t)mi * cout + ni] = acc[x][y];
    }
  }
}

// dw[e] = the sum over chunks of partials[c, e]: warp w of a block sums
// the w-th of RW consecutive ranges of chunks in order, for 32 elements,
// and warp 0 adds the ranges' sums in order
constexpr int RW = 8;

__global__ void __launch_bounds__(32 * RW)
conv_dw_reduce_kernel(const float* __restrict__ partials, int n_chunks,
                      int64_t size, float* __restrict__ dw) {
  __shared__ float s[RW][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t e = (int64_t)blockIdx.x * 32 + lane;
  const int per = (n_chunks + RW - 1) / RW;
  const int c1 = min(n_chunks, (w + 1) * per);
  float sum = 0.f;
  if (e < size) {
#pragma unroll 4
    for (int c = w * per; c < c1; ++c) sum += __ldg(partials + c * size + e);
  }
  s[w][lane] = sum;
  __syncthreads();
  if (w == 0 && e < size) {
    float total = s[0][lane];
#pragma unroll
    for (int r = 1; r < RW; ++r) total += s[r][lane];
    dw[e] = total;
  }
}

// the ring's dynamic shared memory is above the 48 KB a launch may take
// without asking, beside the compaction's static buffers
template <int TM, bool VEC>
void launch_wide(dim3 grid, dim3 block, size_t ring, const float* feats,
                 int cin, const int32_t* rows, int k_out, int ta,
                 const float* g, int cout, int bm, int bn, int chunk_rows,
                 float* out, cudaStream_t s) {
  cudaFuncSetAttribute(conv_dw_wide<TM, VEC>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       NS * BK * 2 * MAX_TILE * (int)sizeof(float));
  conv_dw_wide<TM, VEC><<<grid, block, ring, s>>>(
      feats, cin, rows, k_out, ta, g, cout, bm, bn, chunk_rows, out);
}

int narrow_edge(int width) { return width <= 8 ? 8 : width <= 16 ? 16 : 32; }

template <int CI, int CO>
void launch_narrow(bool vec, dim3 grid, dim3 block, const float* feats,
                   int cin, const int32_t* rows, int k_out, int ta,
                   const float* g, int cout, int taps, int chunk_rows,
                   float* out, cudaStream_t s) {
  if (vec)
    conv_dw_narrow<CI, CO, true><<<grid, block, 0, s>>>(
        feats, cin, rows, k_out, ta, g, cout, taps, chunk_rows, out);
  else
    conv_dw_narrow<CI, CO, false><<<grid, block, 0, s>>>(
        feats, cin, rows, k_out, ta, g, cout, taps, chunk_rows, out);
}

template <int CI>
void launch_narrow_co(int co, bool vec, dim3 grid, dim3 block,
                      const float* feats, int cin, const int32_t* rows,
                      int k_out, int ta, const float* g, int cout, int taps,
                      int chunk_rows, float* out, cudaStream_t s) {
  if (co == 8)
    launch_narrow<CI, 8>(vec, grid, block, feats, cin, rows, k_out, ta, g,
                         cout, taps, chunk_rows, out, s);
  else if (co == 16)
    launch_narrow<CI, 16>(vec, grid, block, feats, cin, rows, k_out, ta, g,
                          cout, taps, chunk_rows, out, s);
  else
    launch_narrow<CI, 32>(vec, grid, block, feats, cin, rows, k_out, ta, g,
                          cout, taps, chunk_rows, out, s);
}

// tile_m, tile_n: narrow, the padded widths (8, 16 or 32); wide, the
// (Cin, Cout) tile (multiples of 8 up to 128). taps: taps per block
// (narrow, 1 to 9; wide, 1). partials: [n_chunks, Ta, Cin, Cout] scratch,
// unused when n_chunks is 1. All from the wrapper's conv_dw_launch.
int conv_dw(const void* feats, int cin, const void* rows, int k_out, int ta,
            const void* g, int cout, int tile_m, int tile_n, int taps,
            int n_chunks, int chunk_rows, void* partials, void* dw,
            void* stream) {
  if (n_chunks < 1 || chunk_rows < 1 || cin < 0 || cout < 0 || ta < 0 ||
      (int64_t)n_chunks * chunk_rows < k_out ||
      (n_chunks > 1 && partials == nullptr))
    return (int)cudaErrorInvalidValue;
  const int64_t size = (int64_t)ta * cin * cout;
  if (size == 0) return (int)cudaGetLastError();
  auto f = (const float*)feats;
  auto rw = (const int32_t*)rows;
  auto gg = (const float*)g;
  auto s = (cudaStream_t)stream;
  float* out = n_chunks > 1 ? (float*)partials : (float*)dw;
  if (k_out == 0) {
    cudaMemsetAsync(dw, 0, size * sizeof(float), s);
    return (int)cudaGetLastError();
  }
  const bool vec = cin % 4 == 0 && cout % 4 == 0 &&
                   ((uintptr_t)feats & 15) == 0 && ((uintptr_t)g & 15) == 0;
  if (cin <= 32 && cout <= 32) {
    if (tile_m != narrow_edge(cin) || tile_n != narrow_edge(cout) ||
        taps < 1 || taps > MAX_G)
      return (int)cudaErrorInvalidValue;
    dim3 grid((ta + taps - 1) / taps, n_chunks);
    dim3 block(32 * taps);
    if (tile_m == 8)
      launch_narrow_co<8>(tile_n, vec, grid, block, f, cin, rw, k_out, ta,
                          gg, cout, taps, chunk_rows, out, s);
    else if (tile_m == 16)
      launch_narrow_co<16>(tile_n, vec, grid, block, f, cin, rw, k_out, ta,
                           gg, cout, taps, chunk_rows, out, s);
    else
      launch_narrow_co<32>(tile_n, vec, grid, block, f, cin, rw, k_out, ta,
                           gg, cout, taps, chunk_rows, out, s);
  } else {
    if (taps != 1 || tile_m < 8 || tile_m > MAX_TILE || tile_m % 8 ||
        tile_n < 8 || tile_n > MAX_TILE || tile_n % 8)
      return (int)cudaErrorInvalidValue;
    const bool tm8 = tile_m * tile_n >= 8192;
    const int compute = (tile_m / (tm8 ? 8 : 4)) * (tile_n / 8);
    dim3 grid(n_chunks * ta * ((cin + tile_m - 1) / tile_m) *
              ((cout + tile_n - 1) / tile_n));
    dim3 block((compute + 31) / 32 * 32 < 64 ? 64 : (compute + 31) / 32 * 32);
    const size_t ring = (size_t)NS * BK * (tile_m + tile_n) * sizeof(float);
    if (tm8 && vec)
      launch_wide<8, true>(grid, block, ring, f, cin, rw, k_out, ta, gg, cout,
                           tile_m, tile_n, chunk_rows, out, s);
    else if (tm8)
      launch_wide<8, false>(grid, block, ring, f, cin, rw, k_out, ta, gg,
                            cout, tile_m, tile_n, chunk_rows, out, s);
    else if (vec)
      launch_wide<4, true>(grid, block, ring, f, cin, rw, k_out, ta, gg, cout,
                           tile_m, tile_n, chunk_rows, out, s);
    else
      launch_wide<4, false>(grid, block, ring, f, cin, rw, k_out, ta, gg,
                            cout, tile_m, tile_n, chunk_rows, out, s);
  }
  int err = (int)cudaGetLastError();
  if (err != 0 || n_chunks == 1) return err;
  const int64_t blocks = (size + 31) / 32;
  conv_dw_reduce_kernel<<<(unsigned)blocks, 32 * RW, 0, s>>>(
      (const float*)partials, n_chunks, size, (float*)dw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int msmd_conv_dw(const void* feats, int cin, const void* rows,
                            int k_out, int ta, const void* g, int cout,
                            int tile_m, int tile_n, int taps, int n_chunks,
                            int chunk_rows, void* partials, void* dw,
                            void* stream) {
  return conv_dw(feats, cin, rows, k_out, ta, g, cout, tile_m, tile_n, taps,
                 n_chunks, chunk_rows, partials, dw, stream);
}
