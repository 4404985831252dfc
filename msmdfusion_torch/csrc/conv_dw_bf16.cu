// Weight gradient of the packed bf16 gather-GEMM sparse convolution on the
// bf16 tensor cores, fp32 sums, with a deterministic reduction.
//
// Replaces the with_dw accumulator of the packed mode of the TPU kernel
// msmdfusion_tpu/ops/sparse/matchconv.py _vgather_kernel (the dw scratch
// that _pallas_bwd reads under MSMD_CONV_DTYPE=bfloat16), which contracted
// bf16 gradient rows with bf16 input features in fp32:
//
//   dw[t] = sum_o bf16(feats[rows[o, t]])^T (x) bf16(g[o])   fp32 sums
//
// dw [Ta, Cin, Cout]; feats [K_in, Cin]; g [K_out, Cout], the gradient of
// the conv's output. Rounding is to nearest even.
//
// Bound on the card: bytes, as chip_smoke.py reckons them: the fp32
// operands it rounds (K_in * Cin and K_out * Cout, read once), the rows
// and dw itself, against 2 * hits * Cin * Cout FLOP at the dense bf16
// tensor rate.
//
// Design, against what held the first version (the fp32 conv_dw's FFMA
// loop with rounded operands) at ~87x that bound:
// - It walks hit pairs only: the plan's RowOrder lists each tap's pairs
//   (input row rows[o, t], output row o), o ascending. A block owns one
//   chunk of one tap's pairs and one TILE x TILE tile of (Cin, Cout).
// - Per stage of 64 pairs (32 at TILE 128), both operands' rows are
//   gathered by 16-byte cp.async copies (4-byte ones where Cin or Cout is
//   not a multiple of 4 or an operand is not 16-byte aligned) through a
//   ring of NS stages, so later stages' gathers are in flight during this
//   one's products; pairs past the chunk are zero-filled.
// - The contraction over the pairs runs on the tensor cores: mma.sync
//   m16n8k16 with A = X^T (Cin x pairs) and B = G (pairs x Cout), both
//   rounded from the staged fp32 rows into bf16 fragments
//   (__floats2bfloat162_rn) as they are loaded. The warps split the tile
//   (four at TILE 32 and 64, eight at 128, which covers the 80-128-wide
//   convs in one tile so that each pair's rows are gathered once) or, at
//   TILE 16, the pairs of a stage, summed in warp order through shared
//   memory.
//   Not yet suited: the 192x192 convs take 2 x 2 tiles of 128, whose
//   second row and column are half empty, so each pair's rows are gathered
//   twice and ~44% of the MMA work is padding (a 192 tile, or 3 x 3 of 64,
//   would avoid one or the other).
// - Deterministic: every chunk writes its own fp32 partial; a second
//   kernel sums each tap's partials in chunk order. No float atomics, so
//   two calls give the same bits. The chunking is a function of the shapes
//   and the plan only (matchconv.conv_dw_bf16_launch).
// Shared-memory row strides (TILE + 4 words) keep the fragment loads free
// of bank conflicts.
//
// The packed engine's kernel alone: the fp32 rulebook engine's x3 route,
// which instantiated this body with three passes (msmd_conv_dw_x3), has
// its own Hopper kernel in conv_dw_x3.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;

constexpr int NS = 3;              // stages in the ring

// per tile edge: warps WM x WN over the tile, each MT m16 and NTL n8
// tiles; WARPS / (WM * WN) warps split each stage's PC pairs
template <int TILE> struct DwTile;
template <> struct DwTile<16> {
  static constexpr int WM = 1, WN = 1, MT = 1, NTL = 2, WARPS = 4, PC = 64;
};
template <> struct DwTile<32> {
  static constexpr int WM = 2, WN = 2, MT = 1, NTL = 2, WARPS = 4, PC = 64;
};
template <> struct DwTile<64> {
  static constexpr int WM = 2, WN = 2, MT = 2, NTL = 4, WARPS = 4, PC = 64;
};
template <> struct DwTile<128> {
  static constexpr int WM = 2, WN = 4, MT = 4, NTL = 4, WARPS = 8, PC = 32;
};

// the tap of chunk b and its pair range [p0, p1)
__device__ __forceinline__ void find_chunk(const int32_t* tap_start, int ta,
                                           int chunk, int b, int* t, int* p0,
                                           int* p1) {
  for (int u = 0; u < ta; ++u) {
    const int begin = __ldg(tap_start + u), end = __ldg(tap_start + u + 1);
    const int n = (end - begin + chunk - 1) / chunk;
    if (b < n) {
      *t = u;
      *p0 = begin + b * chunk;
      *p1 = min(end, *p0 + chunk);
      return;
    }
    b -= n;
  }
  *t = -1;
  *p0 = *p1 = 0;
}

// one TILE x TILE tile of (Cin, Cout) per block
template <int TILE, int VEC>
__global__ void __launch_bounds__(DwTile<TILE>::WARPS * 32)
conv_dw_bf16_kernel(const float* __restrict__ feats, int cin,
                    const float* __restrict__ g, int cout, int ta,
                    const int32_t* __restrict__ pair_in,
                    const int32_t* __restrict__ pair_out,
                    const int32_t* __restrict__ tap_start, int chunk,
                    float* __restrict__ partials) {
  using T = DwTile<TILE>;
  constexpr int WM = T::WM, WN = T::WN, MT = T::MT, NTL = T::NTL;
  constexpr int PC = T::PC, NT = T::WARPS * 32, TPP = NT / PC;
  constexpr int WK = T::WARPS / (WM * WN);
  static_assert(WM * 16 * MT == TILE && WN * 8 * NTL == TILE, "tile");
  static_assert(NT % PC == 0, "whole threads per pair");
  constexpr int S = TILE + 4;                  // fp32 per staged row
  constexpr int OP = PC * S;                   // floats of one operand
  constexpr int PER_ROW = TILE * 4 / VEC;      // copies per operand row
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, c = lane % 4;
  const int wm = warp % WM, wn = (warp / WM) % WN, wk = warp / (WM * WN);
  const int m0 = blockIdx.y * TILE;            // Cin
  const int n0 = blockIdx.z * TILE;            // Cout
  int t, p0, p1;
  find_chunk(tap_start, ta, chunk, blockIdx.x, &t, &p0, &p1);
  const int units = (p1 - p0 + PC - 1) / PC;

  // stage unit u: its pairs' input rows (X) and gradient rows (G)
  auto load = [&](int u, int st) {
    float* xs = smem + st * 2 * OP;
    float* gs = xs + OP;
    const int k = tid / TPP;
    const int p = p0 + u * PC + k;
    const bool live = p < p1;
    const float* xrow = feats + (int64_t)(live ? __ldg(pair_in + p) : 0) * cin;
    const float* grow = g + (int64_t)(live ? __ldg(pair_out + p) : 0) * cout;
#pragma unroll
    for (int j = tid % TPP; j < PER_ROW; j += TPP) {
      const int col = j * (VEC / 4);
      const bool xok = live && m0 + col < cin;
      const bool gok = live && n0 + col < cout;
      if constexpr (VEC == 16) {
        cp_async16(xs + k * S + col, xok ? xrow + m0 + col : feats, xok);
        cp_async16(gs + k * S + col, gok ? grow + n0 + col : g, gok);
      } else {
        cp_async4(xs + k * S + col, xok ? xrow + m0 + col : feats, xok);
        cp_async4(gs + k * S + col, gok ? grow + n0 + col : g, gok);
      }
    }
  };

  float acc[MT][NTL][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < units) load(s, s);
    cp_async_commit();
  }
  for (int u = 0; u < units; ++u) {
    cp_async_wait<NS - 2>();
    __syncthreads();                // unit u landed; unit u-1's stage free
    if (u + NS - 1 < units) load(u + NS - 1, (u + NS - 1) % NS);
    cp_async_commit();
    const float* xs = smem + (u % NS) * 2 * OP;
    const float* gs = xs + OP;
#pragma unroll
    for (int ks = wk * 16; ks < PC; ks += 16 * WK) {
      const float* x0 = xs + (ks + 2 * c) * S + wm * 16 * MT + gq;
      const float* g0 = gs + (ks + 2 * c) * S + wn * 8 * NTL + gq;
      uint32_t a[MT][4], b[NTL][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* x = x0 + i * 16;
        a[i][0] = pack_bf16(x[0], x[S]);
        a[i][1] = pack_bf16(x[8], x[S + 8]);
        a[i][2] = pack_bf16(x[8 * S], x[9 * S]);
        a[i][3] = pack_bf16(x[8 * S + 8], x[9 * S + 8]);
      }
#pragma unroll
      for (int j = 0; j < NTL; ++j) {
        const float* y = g0 + j * 8;
        b[j][0] = pack_bf16(y[0], y[S]);
        b[j][1] = pack_bf16(y[8 * S], y[9 * S]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NTL; ++j) mma(acc[i][j], a[i], b[j]);
    }
  }

  // this chunk's partial [Cin, Cout] tile
  float* dst = partials + (int64_t)blockIdx.x * cin * cout;
  if constexpr (WK > 1) {
    // the warps' sums of the same tile, added in warp order
    cp_async_wait<0>();
    __syncthreads();
    float* red = smem;                          // [WK][TILE][TILE]
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NTL; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = wm * 16 * MT + i * 16 + gq + 8 * (e / 2);
          const int n = wn * 8 * NTL + j * 8 + 2 * c + (e & 1);
          red[(wk * TILE + m) * TILE + n] = acc[i][j][e];
        }
    __syncthreads();
    for (int e = tid; e < TILE * TILE; e += NT) {
      const int m = e / TILE, n = e - m * TILE;
      if (m0 + m >= cin || n0 + n >= cout) continue;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WK; ++w) s += red[w * TILE * TILE + e];
      dst[(int64_t)(m0 + m) * cout + n0 + n] = s;
    }
  } else {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NTL; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + wm * 16 * MT + i * 16 + gq + 8 * (e / 2);
          const int n = n0 + wn * 8 * NTL + j * 8 + 2 * c + (e & 1);
          if (m < cin && n < cout) dst[(int64_t)m * cout + n] = acc[i][j][e];
        }
  }
}

// dw[t] = sum over tap t's chunks, in chunk order, of their partials
__global__ void conv_dw_bf16_reduce_kernel(const float* __restrict__ partials,
                                           const int32_t* __restrict__ tap_start,
                                           int ta, int chunk, int64_t tile_size,
                                           float* __restrict__ dw) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= ta * tile_size) return;
  const int t = (int)(e / tile_size);
  const int64_t inner = e - t * tile_size;
  int first = 0;
  for (int u = 0; u < t; ++u)
    first += (__ldg(tap_start + u + 1) - __ldg(tap_start + u) + chunk - 1) /
             chunk;
  const int n = (__ldg(tap_start + t + 1) - __ldg(tap_start + t) + chunk - 1) /
                chunk;
  float s = 0.f;
  for (int k = 0; k < n; ++k)
    s += __ldg(partials + (first + k) * tile_size + inner);
  dw[e] = s;
}

template <int TILE, int VEC>
int launch(const float* feats, int cin, const float* g, int cout, int ta,
           const int32_t* pair_in, const int32_t* pair_out,
           const int32_t* tap_start, int chunk, int n_chunks,
           float* partials, cudaStream_t stream) {
  using T = DwTile<TILE>;
  constexpr int BYTES = NS * 2 * T::PC * (TILE + 4) * 4;
  static_assert(T::WARPS / (T::WM * T::WN) * TILE * TILE <=
                    NS * 2 * T::PC * (TILE + 4),
                "the warps' sums fit the ring");
  auto kernel = conv_dw_bf16_kernel<TILE, VEC>;
  if (BYTES > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(n_chunks, (cin + TILE - 1) / TILE, (cout + TILE - 1) / TILE);
  kernel<<<grid, T::WARPS * 32, BYTES, stream>>>(
      feats, cin, g, cout, ta, pair_in, pair_out, tap_start, chunk, partials);
  return (int)cudaGetLastError();
}

template <int VEC>
int dispatch_tile(int tile, const float* f, int cin, const float* g, int cout,
                  int ta, const int32_t* pi, const int32_t* po,
                  const int32_t* ts, int chunk, int n_chunks, float* part,
                  cudaStream_t s) {
  switch (tile) {
    case 16:
      return launch<16, VEC>(f, cin, g, cout, ta, pi, po, ts, chunk,
                             n_chunks, part, s);
    case 32:
      return launch<32, VEC>(f, cin, g, cout, ta, pi, po, ts, chunk,
                             n_chunks, part, s);
    case 64:
      return launch<64, VEC>(f, cin, g, cout, ta, pi, po, ts, chunk,
                             n_chunks, part, s);
    case 128:
      return launch<128, VEC>(f, cin, g, cout, ta, pi, po, ts, chunk,
                              n_chunks, part, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// pair_in, pair_out [hits] and tap_start [Ta + 1] from the plan's RowOrder;
// tile 16, 32, 64 or 128; chunk a multiple of 64; n_chunks = sum over taps of ceil(hits_t / chunk);
// partials: [max(n_chunks, 1), Cin, Cout] scratch.
extern "C" int msmd_conv_dw_bf16(const void* feats, int cin, const void* g,
                                 int cout, int ta, const void* pair_in,
                                 const void* pair_out, const void* tap_start,
                                 int tile, int chunk, int n_chunks,
                                 void* partials, void* dw, void* stream) {
  if (chunk < 1 || n_chunks < 0 || partials == nullptr)
    return (int)cudaErrorInvalidValue;
  const int64_t tile_size = (int64_t)cin * cout;
  if (ta == 0 || tile_size == 0) return (int)cudaGetLastError();
  auto s = (cudaStream_t)stream;
  auto f = (const float*)feats;
  auto gg = (const float*)g;
  auto pi = (const int32_t*)pair_in;
  auto po = (const int32_t*)pair_out;
  auto ts = (const int32_t*)tap_start;
  auto part = (float*)partials;
  if (n_chunks > 0) {
    const bool vec16 = cin % 4 == 0 && cout % 4 == 0 &&
                       (uintptr_t)feats % 16 == 0 && (uintptr_t)g % 16 == 0;
    int err = vec16 ? dispatch_tile<16>(tile, f, cin, gg, cout, ta, pi, po,
                                        ts, chunk, n_chunks, part, s)
                    : dispatch_tile<4>(tile, f, cin, gg, cout, ta, pi, po, ts,
                                       chunk, n_chunks, part, s);
    if (err != 0) return err;
  }
  const int threads = 256;
  const int64_t blocks = (ta * tile_size + threads - 1) / threads;
  conv_dw_bf16_reduce_kernel<<<(unsigned)blocks, threads, 0, s>>>(
      part, ts, ta, chunk, tile_size, (float*)dw);
  return (int)cudaGetLastError();
}
