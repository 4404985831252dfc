// The exact fp32 sparse convolution (FFMA: fp32 products and sums, no TF32,
// no bf16 split) with the inference epilogue fused in, templated on where a
// block finds its rows: the shared body of gather_gemm_conv.cu (rulebook
// rows) and match_conv.cu's msmd_match_conv (a binary search of each
// query). Both compute
//
//   out[r] = epi( sum_t feats[row(r, t)] @ W[t] ),   row(r, t) = -1: miss
//   epi(v) = valid[r] ? relu?(v * scale + shift) : 0     (in fp32)
//
// feats [K_in, Cin], W [Ta, Cin, Cout], out [K_out, Cout], all fp32. The
// training backward runs the same body for d_feats over the transpose
// plan with the weights tap-flipped and transposed.
//
// A block owns BM = 128 output rows and one column tile of up to 128
// output channels (the wrapper's matchconv.ffma_launch: Cout cut into the
// fewest tiles of at most 128, multiples of 8, so 192 is 2 x 96 and 80 and
// 96 stay whole), held in a register tile of 16, 32, 64, 80, 96 or 128
// columns. A second column block exists only above 128 channels.
//
// - Rows found once per block: the BM x Ta rows (read from the rulebook,
//   or searched, the taps of one row on neighbouring threads) go to shared
//   memory, and each tap's hits are compacted there in ascending row order
//   (ballots): its n_t input rows and the block rows they belong to.
// - Only hits are multiplied: per tap, warp w takes the tap's w-th
//   16-hit slice and all of the column tile, so the tap costs
//   ceil(n_t / 16) slices, not the block's 128 rows. Each slice's sum over
//   the tap's channels stays in registers; at the tap's last chunk it is
//   added to the block's fp32 accumulator in shared memory at each hit's
//   block row, taps in ascending order. (A first design kept each warp's
//   16 block rows in registers, sorted by tap-hit mask as match_conv_x3
//   does, and skipped the taps they missed: it multiplied 1.4x the hits
//   on the flagship's frame, a useful share of 0.62 against 0.89, and ran
//   slower on the H100. Keeping more warps busy at a stage, by items of
//   16 rows x 32 columns, stages of two taps or a tap's few slices cut
//   into column groups, ran no faster.)
// - Pipelined gathers: per (tap, chunk of kc input channels), ascending,
//   the tap's compacted rows in whole slices [16 S][kc] (zero past its
//   hits and past Cin, nothing read for them) and the weight chunk
//   [kc][tile] go into a ring of 2 stages by 16-byte cp.async (4-byte
//   where Cin or Cout is not a multiple of 4 or a view is unaligned), one
//   barrier a stage, so the next stage's gathers overlap this one's
//   products. kc is 32 where it divides Cin at tiles of 64 or less and
//   128, else 16 (two blocks of 80- and 96-column stages share an SM), 8
//   below; Cin 16 walks 16-deep chunks and stages no padding.
// - Register tiles: a warp holds its slice's 16 rows x the column tile,
//   each thread TM rows (16 / TM row threads, rows interleaved) x TN = 4R
//   columns (WTX column threads; its columns in R runs of 4, each run of
//   the warp contiguous), so a warp's 16-byte loads of the weights and
//   8-byte loads of a row's k pair meet no bank conflict (rows padded by
//   4 floats). Per k pair: TM 8-byte and 2R 16-byte shared loads for 2 x
//   TM x TN FFMAs.
//
// Determinism: each output element is the sum, taps ascending, of each
// tap's FFMA chain over its channels ascending, one thread per tap and
// element; the launch is a function of the shapes only. Two calls give the
// same bits; no atomics.
//
// Bound on the card: 2 * hits * Cin * Cout FLOP at the fp32 FFMA rate
// against the features, the plan (rows, or the keys and the queries), the
// weights and the epilogue's vectors read once and the output written
// once: the narrow convs (Cin, Cout <= 32) are bound by bytes, the wide
// ones by operations.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace ffma_conv {

using mma_bf16::cp_async16;
using mma_bf16::cp_async4;
using mma_bf16::cp_async_commit;
using mma_bf16::cp_async_wait;

constexpr int BM = 128;              // output rows per block
constexpr int SLICE = 16;            // hits of a warp's slice
constexpr int WARPS = BM / SLICE;
constexpr int NT = WARPS * 32;       // threads
constexpr int MAX_TAPS = 64;         // taps the block's lists hold
constexpr int SR = BM + 1;           // s_rows' stride: its stores spread
constexpr int PAD = 4;               // floats after each staged row
constexpr int NS = 2;                // ring stages

// the register tile of a column tile of NP channels: WTX column threads
// and 32 / WTX row threads a warp, R runs of 4 columns a thread
template <int NP> struct Tile;
template <> struct Tile<16> { static constexpr int WTX = 4, R = 1; };
template <> struct Tile<32> { static constexpr int WTX = 8, R = 1; };
template <> struct Tile<64> { static constexpr int WTX = 8, R = 2; };
template <> struct Tile<80> { static constexpr int WTX = 4, R = 5; };
template <> struct Tile<96> { static constexpr int WTX = 8, R = 3; };
template <> struct Tile<128> { static constexpr int WTX = 16, R = 2; };

// bytes of s_rows [Ta][SR] int32 (the compacted hits' input rows) and
// s_pos [Ta][BM] uint8 (their block rows), 16-byte rounded
inline __host__ __device__ size_t rows_bytes(int ta) {
  return ((size_t)ta * SR * 4 + (size_t)ta * BM + 15) / 16 * 16;
}

// bytes of dynamic shared memory: the accumulator [BM][NP], the rows, the
// ring of stages, each [BM][kc + PAD] gathered rows and [kc][NP] weights
template <int NP>
size_t smem_bytes(int ta, int kc) {
  return (size_t)BM * NP * 4 + rows_bytes(ta) +
         (size_t)NS * (BM * (kc + PAD) + kc * NP) * 4;
}

struct Epilogue {
  const float* scale;       // [Cout] or null
  const float* shift;       // [Cout] or null
  int relu;
  const uint8_t* valid;     // [K_out] or null
};

// Src: int ta and __device__ int32_t row(int r, int t) const, the input
// row of output row r at tap t (r < k_out), or -1. (The 128-column
// accumulator and stages leave one block an SM.)
template <class Src, int NP>
__global__ void __launch_bounds__(NT, NP == 128 ? 1 : 2)
conv_kernel(const float* __restrict__ feats, int cin, Src src, int k_out,
            const float* __restrict__ weights, int cout, int tile_n, int kc,
            int lg_kc, int vec_a, int vec_b, int vec_o, Epilogue epi,
            float* __restrict__ out) {
  constexpr int WTX = Tile<NP>::WTX, R = Tile<NP>::R;
  constexpr int WTY = 32 / WTX, TM = SLICE / WTY, TN = 4 * R;
  static_assert(WTX * TN == NP && WTY * TM == SLICE, "tile");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_n[MAX_TAPS];        // hits of each tap in the block
  __shared__ int s_taps[MAX_TAPS];     // the taps with hits, ascending
  __shared__ int s_ntaps;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ta = src.ta;
  const int r0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * tile_n;
  float* s_acc = reinterpret_cast<float*>(smem);                 // [BM][NP]
  int* s_rows = reinterpret_cast<int*>(s_acc + BM * NP);         // [ta][SR]
  uint8_t* s_pos = reinterpret_cast<uint8_t*>(s_rows + ta * SR); // [ta][BM]
  float* ring = reinterpret_cast<float*>(
      smem + (size_t)BM * NP * 4 + rows_bytes(ta));
  const int sa = kc + PAD;
  const int a_floats = BM * sa;
  const int stage = a_floats + kc * NP;

  // the block's BM x Ta rows, once
  for (int e = tid; e < BM * ta; e += NT) {
    const int m = e / ta, t = e - m * ta;
    const int r = r0 + m;
    s_rows[t * SR + m] = r < k_out ? src.row(r, t) : -1;
  }
  for (int e = tid; e < BM * NP / 4; e += NT)
    reinterpret_cast<float4*>(s_acc)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  // each tap's hits compacted in place, ascending: a warp per tap, 32 rows
  // a ballot (a chunk is read before any of its positions is written)
  for (int t = warp; t < ta; t += WARPS) {
    int n = 0;
    for (int q = 0; q < BM; q += 32) {
      const int v = s_rows[t * SR + q + lane];
      const unsigned hit = __ballot_sync(0xffffffffu, v >= 0);
      const int at = n + __popc(hit & ((1u << lane) - 1u));
      __syncwarp();
      if (v >= 0) {
        s_rows[t * SR + at] = v;
        s_pos[t * BM + at] = (uint8_t)(q + lane);
      }
      n += __popc(hit);
    }
    if (lane == 0) s_n[t] = n;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int t = 0; t < ta; ++t)
      if (s_n[t]) s_taps[n++] = t;
    s_ntaps = n;
  }
  __syncthreads();

  const int nkc = (cin + kc - 1) >> lg_kc;
  const int units = s_ntaps * nkc;     // (tap, Cin chunk), taps ascending
  // a staged row's copies: 16 or 4 bytes each
  const int va = vec_a ? 4 : 1, lg_per_a = vec_a ? lg_kc - 2 : lg_kc;

  // stage unit u into ring stage st: its tap's hits in whole slices (zero
  // past the hits and past Cin) and its weight chunk (zero past Cin and
  // past the column tile)
  auto load = [&](int u, int st) {
    const int t = s_taps[u / nkc];
    const int k0 = (u - u / nkc * nkc) << lg_kc;
    float* as = ring + st * stage;
    float* bs = as + a_floats;
    const int nh = s_n[t];
    const int nrows = (nh + SLICE - 1) / SLICE * SLICE;
    for (int e = tid; e < nrows << lg_per_a; e += NT) {
      const int p = e >> lg_per_a;
      const int c = (e - (p << lg_per_a)) * va;
      const int row = p < nh ? s_rows[t * SR + p] : -1;
      const bool ok = row >= 0 && k0 + c < cin;
      const float* g = ok ? feats + (int64_t)row * cin + k0 + c : feats;
      if (vec_a)
        cp_async16(as + p * sa + c, g, ok);
      else
        cp_async4(as + p * sa + c, g, ok);
    }
    const float* w = weights + ((int64_t)t * cin + k0) * cout + n0;
    if (vec_b) {
      for (int e = tid; e < kc * (NP / 4); e += NT) {
        const int k = e / (NP / 4), n = (e - k * (NP / 4)) * 4;
        const bool ok = k0 + k < cin && n < tile_n && n0 + n < cout;
        cp_async16(bs + k * NP + n, ok ? w + (int64_t)k * cout + n : weights,
                   ok);
      }
    } else {
      for (int e = tid; e < kc * NP; e += NT) {
        const int k = e / NP, n = e - k * NP;
        const bool ok = k0 + k < cin && n < tile_n && n0 + n < cout;
        cp_async4(bs + k * NP + n, ok ? w + (int64_t)k * cout + n : weights,
                  ok);
      }
    }
  };

  const int ty = lane / WTX, tx = lane - ty * WTX;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < units) load(s, s);
    cp_async_commit();
  }
  for (int u = 0; u < units; ++u) {
    cp_async_wait<NS - 2>();
    __syncthreads();                 // unit u landed; unit u-1's stage free
    if (u + NS - 1 < units) load(u + NS - 1, (u + NS - 1) % NS);
    cp_async_commit();
    const int t = s_taps[u / nkc];
    const int nh = s_n[t];
    if (warp * SLICE >= nh) continue;          // warp-uniform: no slice
    const int k0 = (u - u / nkc * nkc) << lg_kc;
    // k pairs up to the last one holding a real channel; the rest of the
    // chunk is zero in both operands
    const int kend = min(kc, (cin - k0 + 1) & ~1);
    const float* as = ring + (u % NS) * stage + (warp * SLICE + ty) * sa;
    const float* bs = ring + (u % NS) * stage + a_floats + tx * 4;
#pragma unroll 2
    for (int k = 0; k < kend; k += 2) {
      float2 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float2*>(as + i * WTY * sa + k);
      float b0[TN], b1[TN];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const float4 x =
            *reinterpret_cast<const float4*>(bs + k * NP + q * WTX * 4);
        const float4 y =
            *reinterpret_cast<const float4*>(bs + (k + 1) * NP + q * WTX * 4);
        b0[4 * q] = x.x, b0[4 * q + 1] = x.y, b0[4 * q + 2] = x.z,
        b0[4 * q + 3] = x.w;
        b1[4 * q] = y.x, b1[4 * q + 1] = y.y, b1[4 * q + 2] = y.z,
        b1[4 * q + 3] = y.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = fmaf(a[i].x, b0[j], acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b1[j], acc[i][j]);
        }
    }
    if (k0 + kc >= cin) {
      // the tap's last chunk: its sums into the block's accumulator, at
      // each hit's block row
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int p = warp * SLICE + ty + i * WTY;
        if (p < nh) {
          float* dst = s_acc + s_pos[t * BM + p] * NP + tx * 4;
#pragma unroll
          for (int q = 0; q < R; ++q) {
            float4 v = *reinterpret_cast<float4*>(dst + q * WTX * 4);
            v.x += acc[i][4 * q], v.y += acc[i][4 * q + 1],
                v.z += acc[i][4 * q + 2], v.w += acc[i][4 * q + 3];
            *reinterpret_cast<float4*>(dst + q * WTX * 4) = v;
          }
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
      }
    }
  }
  __syncthreads();

  // epilogue on the fp32 sums, a row's columns on neighbouring threads
  for (int e = tid; e < BM * NP / 4; e += NT) {
    const int m = e / (NP / 4), c = (e - m * (NP / 4)) * 4;
    if (r0 + m >= k_out || c >= tile_n || n0 + c >= cout) continue;
    const bool keep = epi.valid == nullptr || epi.valid[r0 + m];
    const float4 a = reinterpret_cast<const float4*>(s_acc)[e];
    float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = n0 + c + q < cout ? n0 + c + q : n0 + c;
      float x = v[q];
      if (epi.scale) x = x * __ldg(epi.scale + col);
      if (epi.shift) x = x + __ldg(epi.shift + col);
      if (epi.relu) x = fmaxf(x, 0.f);
      v[q] = keep ? x : 0.f;
    }
    float* o = out + (int64_t)(r0 + m) * cout + n0 + c;
    if (vec_o) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (c + q < tile_n && n0 + c + q < cout) o[q] = v[q];
    }
  }
}

template <class Src, int NP>
int launch_tile(const float* feats, int cin, const Src& src, int k_out,
                const float* weights, int cout, int tile_n, int kc,
                const Epilogue& epi, float* out, cudaStream_t stream) {
  const size_t bytes = smem_bytes<NP>(src.ta, kc);
  auto kernel = conv_kernel<Src, NP>;
  // always: the static buffers count against the 48 KB a block gets
  // without the attribute
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int lg_kc = kc == 8 ? 3 : kc == 16 ? 4 : 5;
  const int vec_a = cin % 4 == 0 && (uintptr_t)feats % 16 == 0;
  const int vec_b = cout % 4 == 0 && (uintptr_t)weights % 16 == 0;
  const int vec_o = cout % 4 == 0 && (uintptr_t)out % 16 == 0;
  dim3 grid((k_out + BM - 1) / BM, (cout + tile_n - 1) / tile_n);
  kernel<<<grid, NT, bytes, stream>>>(feats, cin, src, k_out, weights, cout,
                                      tile_n, kc, lg_kc, vec_a, vec_b, vec_o,
                                      epi, out);
  return (int)cudaGetLastError();
}

// tile (16, 32, 64, 80, 96 or 128: the register tile), tile_n (output
// channels per column block, a multiple of 8, at most tile) and kc (8, 16
// or 32) from the wrapper's matchconv.ffma_launch; at most MAX_TAPS taps
template <class Src>
int conv(const void* feats, int cin, const Src& src, int k_out,
         const void* weights, int cout, int tile, int tile_n, int kc,
         const void* scale, const void* shift, int relu,
         const void* out_valid, void* out, void* stream) {
  if (src.ta < 1 || src.ta > MAX_TAPS || cin < 0 || k_out < 0 ||
      cout < 0 || tile_n < 8 || tile_n % 8 || tile_n > tile ||
      (kc != 8 && kc != 16 && kc != 32))
    return (int)cudaErrorInvalidValue;
  if (k_out == 0 || cout == 0) return (int)cudaGetLastError();
  auto f = (const float*)feats;
  auto w = (const float*)weights;
  Epilogue epi{(const float*)scale, (const float*)shift, relu,
               (const uint8_t*)out_valid};
  auto o = (float*)out;
  auto s = (cudaStream_t)stream;
#define MSMD_FFMA_TILE(N)                                                 \
  case N:                                                                 \
    return launch_tile<Src, N>(f, cin, src, k_out, w, cout, tile_n, kc,   \
                               epi, o, s);
  switch (tile) {
    MSMD_FFMA_TILE(16)
    MSMD_FFMA_TILE(32)
    MSMD_FFMA_TILE(64)
    MSMD_FFMA_TILE(80)
    MSMD_FFMA_TILE(96)
    MSMD_FFMA_TILE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MSMD_FFMA_TILE
}

}  // namespace ffma_conv
