// The fp32 rulebook engine's default sparse convolution (the x3 route) on
// Hopper's warpgroup tensor cores: both operands split into bf16 hi + lo,
// three products with fp32 sums, lo.lo dropped, with the inference
// epilogue (BN affine, ReLU, valid mask) fused in. It serves the forward
// and, over the dual rows, the training backward's input gradient.
//
// Replaces the fp32 mode of the TPU kernel
// msmdfusion_tpu/ops/sparse/matchconv.py _vgather_kernel under its default
// gemm_mode() 'x3' (matchconv.py:1115-1134):
//
//   out[r] = epi( sum_t hi(f) @ hi(W[t]) + hi(f) @ lo(W[t])
//                       + lo(f) @ hi(W[t]) )       f = feats[rows[r, t]]
//   hi(x) = bf16_rn(x), lo(x) = bf16_rn(x - float(hi(x)))
//   epi(v) = valid[r] ? relu?(v * scale + shift) : 0             on fp32
//
// about 2^-17 of each sum's magnitude from the exact fp32 product.
//
// Bound on the card: operations, as chip_smoke.py reckons them: 3 x 2 *
// hits * Cin * Cout FLOP at the dense bf16 tensor rate, against the bytes
// of the features (read once), the rows and their order, the weights, the
// epilogue's vectors and the fp32 output.
//
// Design (sm_90a), against what held the mma.sync version at ~11x that
// bound (one block-wide barrier per 16- or 32-deep chunk, two or three
// chunks in flight, one warp per 16-row slice over all columns):
// - A block owns BM = 128 output rows of the plan's RowOrder (rows stably
//   sorted by their tap-hit mask) and all of Cout, padded to NP (at most
//   208; wider convs take column blocks): each gathered row is read once
//   per tap. Two consumer warpgroups own 64 rows each and one producer
//   warpgroup fills a ring of NS stages; setmaxnreg hands the producer's
//   registers to the consumers. One block fills an SM's shared memory and
//   registers, two up to 32 columns.
// - A stage holds UNITS = 4 units of 16 channels of K (64 of K), a unit
//   being one tap's 16-deep chunk of Cin, units in (tap, chunk) order over
//   the taps the block's rows hit: at Cin 16 one stage holds four taps, at
//   Cin 32 two. Each 64-row tile multiplies only the units of taps some
//   row of it hits (the OR of its masks); its rows' other units are not
//   even copied.
// - The gather: each producer thread owns one row and copies its 64-byte
//   piece of each unit with 16-byte cp.async (4-byte ones where Cin is not
//   a multiple of 4 or the features are not 16-byte aligned; zeros for a
//   miss and past Cin), completing on the stage's full mbarrier
//   (cp.async.mbarrier.arrive). Bulk copies of the pieces measured slower:
//   they queue on the TMA unit behind the weights'. The weights: the
//   wrapper lays them out once per call as, per column block, tap and
//   unit, the hi then the lo part in wgmma's K-major core-matrix order
//   (matchconv.x3_layout), so each unit's weights are one contiguous bulk
//   copy by the TMA unit on the same mbarrier. Consumers wait on that
//   barrier and free the stage on its empty one: no block-wide barrier in
//   the main loop.
// - The product: wgmma m64nNk16 with A from registers, split into hi and
//   lo from the staged fp32 rows (row stride 72 words: the fragment loads
//   are free of bank conflicts), B the weights' hi and lo in shared
//   memory. Per unit a fresh accumulator takes the unit's three products
//   (a chain of 3 wgmma, 48 products deep) and is added to the running
//   fp32 sum by one fp32 add: the tensor cores round their sums toward
//   zero, and a long chain in one accumulator drifts from the sum (CHAIN).
//   Above 128 columns the fresh accumulator covers half of them at a time
//   (N = 96 or 104), so that it fits beside the running sum.
// - Each row's sum runs over its taps in ascending order and the stages
//   in a fixed order; each result row is written to its original
//   position. No atomics: two calls give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "wgmma_x3.cuh"

namespace {

using namespace mma_bf16;
using namespace wgmma_x3;

constexpr int BM = 128;              // sorted output rows per block
constexpr int CONSUMERS = 2;         // warpgroups of 64 rows
constexpr int NT = (CONSUMERS + 1) * 128;
constexpr int UNITS = 4;             // 16-deep units of K per stage
constexpr int AHEAD = 4;             // stages the row indices load ahead
// units a fresh accumulator takes: the tensor cores' sums round toward
// zero, so a chain of 4 units (12 wgmma) biased each sum ~3x as far from
// the x3 plain version as one unit (3 wgmma, the mma.sync kernel's
// fragment) does: on a flagship bf16-compute step that bias moved a
// decoder loss 77x the plain path's own spread. One unit costs up to ~5%
// of the time (x3_study.py), less at 192 columns.
constexpr int CHAIN = 1;
constexpr int SA = UNITS * 16 + 8;   // fp32 per staged row
constexpr int A_BYTES = BM * SA * 4;
constexpr int MAX_TAPS = 62;         // the tap-hit mask is an int64
// dynamic shared memory of one block an SM (227 KB a block at most), and
// of each of two (228 KB an SM, 1 KB of it reserved a block), static aside
constexpr int ONE_SMEM = 232448 - 2048;
constexpr int TWO_SMEM = 233472 / 2 - 4096;

// Up to 32 columns two blocks share an SM (each one's prologue and first
// gathers overlap the other's products), with half the registers and
// shared memory each; wider, one block fills it.
template <int NP>
struct Fwd {
  static constexpr int BLOCKS = NP <= 32 ? 2 : 1;   // per SM
  static constexpr int PRODUCER_REGS = BLOCKS == 2 ? 40 : 56;
  static constexpr int CONSUMER_REGS = BLOCKS == 2 ? 96 : 224;
  // the registers a thread starts with (ptxas takes all the launch bounds
  // allow); setmaxnreg moves registers between a block's own warps only
  static constexpr int ENTRY_REGS = 65536 / (NT * BLOCKS) / 8 * 8;
  static constexpr int NH = NP > 128 ? 2 : 1;       // column halves
  static constexpr int NC = NP / NH;                // fresh accumulator
  static constexpr int UNIT_BYTES = NP * 16 * 2 * 2;  // hi + lo
  static constexpr int STAGE = A_BYTES + UNITS * UNIT_BYTES;
  static constexpr int SMEM = BLOCKS == 2 ? TWO_SMEM : ONE_SMEM;
  static constexpr int NS = SMEM / STAGE < 8 ? SMEM / STAGE : 8;
  static constexpr int BYTES = NS * STAGE;
  static_assert(NC % 8 == 0 && NS >= 2, "layout");
  static_assert(128 * PRODUCER_REGS + CONSUMERS * 128 * CONSUMER_REGS <=
                    NT * ENTRY_REGS,
                "the consumers take no more than the producer gives up");
};

template <int NP>
__global__ void __launch_bounds__(NT, Fwd<NP>::BLOCKS)
gather_conv_x3_kernel(const float* __restrict__ feats, int cin, int vec16,
                      const int32_t* __restrict__ rows, int k_out, int ta,
                      const int64_t* __restrict__ perm,
                      const int64_t* __restrict__ masks,
                      const __nv_bfloat16* __restrict__ wl, int units_per_tap,
                      int cout, const float* __restrict__ scale,
                      const float* __restrict__ shift, int relu,
                      const uint8_t* __restrict__ out_valid,
                      float* __restrict__ out) {
  using F = Fwd<NP>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_orig[BM];
  __shared__ unsigned long long s_part[4];
  __shared__ unsigned long long s_tile[CONSUMERS];
  __shared__ int s_taps[64];
  __shared__ int s_ntaps;
  __shared__ __align__(8) uint64_t full[F::NS];
  __shared__ __align__(8) uint64_t empty[F::NS];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = blockIdx.x * BM;

  if (tid < BM)
    s_orig[tid] = r0 + tid < k_out ? (int)__ldg(perm + r0 + tid) : -1;
  if (warp < 4) {            // the OR of each 32 rows' tap-hit masks
    const int r = r0 + warp * 32 + lane;
    unsigned long long m =
        r < k_out ? (unsigned long long)__ldg(masks + r) : 0ull;
    for (int off = 16; off > 0; off >>= 1)
      m |= __shfl_xor_sync(0xffffffffu, m, off);
    if (lane == 0) s_part[warp] = m;
  }
  if (tid == 0) {
    for (int s = 0; s < F::NS; ++s) {
      mbar_init(&full[s], 128);              // one a producer thread
      mbar_init(&empty[s], CONSUMERS * 4);   // one per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    s_tile[0] = s_part[0] | s_part[1];
    s_tile[1] = s_part[2] | s_part[3];
    int n = 0;
    for (unsigned long long m = s_tile[0] | s_tile[1]; m; m &= m - 1)
      s_taps[n++] = __ffsll((long long)m) - 1;
    s_ntaps = n;
  }
  __syncthreads();

  const int units = s_ntaps * units_per_tap;   // (tap, chunk), ascending
  const int stages = (units + UNITS - 1) / UNITS;

  if (warp >= CONSUMERS * 4) {
    // producer warpgroup: thread p stages row p of every unit its tile
    // multiplies; thread 0 also the weights
    setmaxnreg_dec<F::PRODUCER_REGS>();
    const int p = tid - CONSUMERS * 128;
    const int orig = s_orig[p];
    const unsigned long long tile = s_tile[p / 64];
    const int32_t* row_taps = rows + (int64_t)(orig < 0 ? 0 : orig) * ta;
    const __nv_bfloat16* wblock =
        wl + (int64_t)blockIdx.y * ta * units_per_tap * (F::UNIT_BYTES / 2);
    // the input row of each unit of stage u: -2 where the tile skips the
    // unit (nothing copied), -1 for a miss (zeros); loaded AHEAD stages
    // ahead, so that the loads' latency hides behind the stages' copies
    auto unit_rows = [&](int u, int* idx) {
#pragma unroll
      for (int j = 0; j < UNITS; ++j) {
        const int unit = u * UNITS + j;
        int r = -2;
        if (unit < units) {
          const int t = s_taps[unit / units_per_tap];
          if ((tile >> t) & 1ull)
            r = orig >= 0 ? __ldg(row_taps + t) : -1;
        }
        idx[j] = r;
      }
    };
    int ahead[AHEAD][UNITS];
#pragma unroll
    for (int d = 0; d < AHEAD; ++d) unit_rows(d, ahead[d]);
    for (int u = 0; u < stages; ++u) {
      const int s = u % F::NS;
      int idx[UNITS];
#pragma unroll
      for (int j = 0; j < UNITS; ++j) {
        idx[j] = ahead[0][j];
#pragma unroll
        for (int d = 0; d + 1 < AHEAD; ++d) ahead[d][j] = ahead[d + 1][j];
      }
      unit_rows(u + AHEAD, ahead[AHEAD - 1]);
      mbar_wait(&empty[s], ((u / F::NS) & 1) ^ 1);
      const int j0 = u * UNITS;
      const int nj = units - j0 < UNITS ? units - j0 : UNITS;
      unsigned char* stage = smem + s * F::STAGE;
      float* arow = reinterpret_cast<float*>(stage) + p * SA;
      // the weights by thread 0, announced on the barrier; each thread's
      // row by cp.async
      if (p == 0) mbar_expect_tx(&full[s], nj * F::UNIT_BYTES);
      if (p == 0) {
        for (int j = 0; j < nj; ++j) {
          const int unit = j0 + j;
          const int t = s_taps[unit / units_per_tap];
          const __nv_bfloat16* src =
              wblock + ((int64_t)t * units_per_tap + unit % units_per_tap) *
                           (F::UNIT_BYTES / 2);
          bulk_copy_g2s(stage + A_BYTES + j * F::UNIT_BYTES, src,
                        F::UNIT_BYTES, &full[s]);
        }
      }
#pragma unroll
      for (int j = 0; j < UNITS; ++j) {
        const int row = idx[j];
        if (row == -2) continue;
        const int k0 = ((j0 + j) % units_per_tap) * 16;
        const float* src = feats + (int64_t)(row < 0 ? 0 : row) * cin;
        float* dst = arow + j * 16;
        if (vec16) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = k0 + 4 * i;
            const bool ok = row >= 0 && col < cin;
            cp_async16(dst + 4 * i, ok ? src + col : feats, ok);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int col = k0 + i;
            const bool ok = row >= 0 && col < cin;
            cp_async4(dst + i, ok ? src + col : feats, ok);
          }
        }
      }
      cp_async_mbar_arrive(&full[s]);
    }
  } else {
    // consumer warpgroups: rows 64 wg .. 64 wg + 63, all NP columns
    setmaxnreg_inc<F::CONSUMER_REGS>();
    const int wg = warp / 4, wi = warp % 4;
    const int g = lane / 4, c = lane % 4;
    const unsigned long long mine = s_tile[wg];
    float acc[NP / 2];
    float fresh[F::NC / 2];
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < F::NC / 2; ++i) fresh[i] = 0.f;

    for (int u = 0; u < stages; ++u) {
      const int s = u % F::NS;
      const int j0 = u * UNITS;
      const int nj = units - j0 < UNITS ? units - j0 : UNITS;
      mbar_wait(&full[s], (u / F::NS) & 1);
      const unsigned char* stage = smem + s * F::STAGE;
      const float* as = reinterpret_cast<const float*>(stage) +
                        (wg * 64 + wi * 16 + g) * SA + 2 * c;
      const uint32_t bbase = smem_addr(stage + A_BYTES);
      uint32_t ahi[UNITS][4], alo[UNITS][4];
      bool act[UNITS];
      bool any = false;
#pragma unroll
      for (int j = 0; j < UNITS; ++j) {
        act[j] = j < nj &&
                 ((mine >> s_taps[(j0 + j) / units_per_tap]) & 1ull);
        any = any || act[j];
        if (act[j]) {
          // rows g and g + 8, columns 2c, 2c + 1 and 2c + 8, 2c + 9
          const float2 v[4] = {
              *reinterpret_cast<const float2*>(as + j * 16),
              *reinterpret_cast<const float2*>(as + 8 * SA + j * 16),
              *reinterpret_cast<const float2*>(as + j * 16 + 8),
              *reinterpret_cast<const float2*>(as + 8 * SA + j * 16 + 8)};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            split_bf16(v[i].x, v[i].y, &ahi[j][i], &alo[j][i]);
        }
      }
      if (any) {
#pragma unroll
        for (int h = 0; h < F::NH; ++h) {
          // a fresh accumulator for every CHAIN units of the stage
#pragma unroll
          for (int j0c = 0; j0c < UNITS; j0c += CHAIN) {
            bool some = false;
#pragma unroll
            for (int j = j0c; j < j0c + CHAIN; ++j) some = some || act[j];
            if (!some) continue;
            wgmma_fence();
            int first = 1;
#pragma unroll
            for (int j = j0c; j < j0c + CHAIN; ++j) {
              if (!act[j]) continue;
              const uint32_t b = bbase + j * F::UNIT_BYTES + h * F::NC * 32;
              const uint64_t d_hi = b_desc(b), d_lo = b_desc(b + NP * 32);
              Wgmma<F::NC>::mma(fresh, ahi[j], d_hi, !first);
              Wgmma<F::NC>::mma(fresh, ahi[j], d_lo, 1);
              Wgmma<F::NC>::mma(fresh, alo[j], d_hi, 1);
              first = 0;
            }
            wgmma_commit();
            wgmma_wait<0>();
#pragma unroll
            for (int i = 0; i < F::NC / 2; ++i) {
              fence_operand(fresh[i]);
              acc[h * (F::NC / 2) + i] += fresh[i];
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // epilogue on the fp32 sums; each sorted row to its original position
    const int n0 = blockIdx.y * NP;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int orig = s_orig[wg * 64 + wi * 16 + g + 8 * hr];
      if (orig < 0) continue;
      const bool keep = out_valid == nullptr || out_valid[orig];
      float* dst = out + (int64_t)orig * cout;
#pragma unroll
      for (int j = 0; j < NP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + j * 8 + 2 * c + e;
          if (n >= cout) continue;
          float v = acc[j * 4 + 2 * hr + e];
          if (scale != nullptr) v = v * __ldg(scale + n);
          if (shift != nullptr) v = v + __ldg(shift + n);
          if (relu) v = fmaxf(v, 0.f);
          dst[n] = keep ? v : 0.f;
        }
    }
  }
}

template <int NP>
int launch(const float* feats, int cin, bool vec16, const int32_t* rows,
           int k_out, int ta, const int64_t* perm, const int64_t* masks,
           const __nv_bfloat16* wl, int col_blocks, int units_per_tap,
           int cout, const float* scale, const float* shift, int relu,
           const uint8_t* out_valid, float* out, cudaStream_t stream) {
  using F = Fwd<NP>;
  auto kernel = gather_conv_x3_kernel<NP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F::BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((k_out + BM - 1) / BM, col_blocks);
  kernel<<<grid, NT, F::BYTES, stream>>>(
      feats, cin, vec16 ? 1 : 0, rows, k_out, ta, perm, masks, wl,
      units_per_tap, cout, scale, shift, relu, out_valid, out);
  return (int)cudaGetLastError();
}

}  // namespace

// wl: the weights' bf16 hi and lo parts laid out by matchconv.x3_layout:
// [col_blocks][Ta][ceil(Cin / 16)][hi, lo][np / 8][2][8][8] (each unit one
// tap's 16-deep chunk of Cin in wgmma's K-major core-matrix order,
// zero-padded); np one of 16/32/64/80/96/128/192/208; perm and masks
// [k_out] (int64) from the plan's RowOrder; Ta at most 62.
extern "C" int msmd_gather_gemm_conv_x3(
    const void* feats, int cin, const void* rows, int k_out, int ta,
    const void* perm, const void* masks, const void* wl, int np,
    int col_blocks, int cout, const void* scale, const void* shift,
    int relu, const void* out_valid, void* out, void* stream) {
  if (ta > MAX_TAPS || ta < 1 || cin < 1 || col_blocks < 1 ||
      col_blocks * np < cout)
    return (int)cudaErrorInvalidValue;
  if (k_out == 0 || cout == 0) return (int)cudaGetLastError();
  const bool vec16 = cin % 4 == 0 && (uintptr_t)feats % 16 == 0;
  const int upt = (cin + 15) / 16;
  auto f = (const float*)feats;
  auto rw = (const int32_t*)rows;
  auto pm = (const int64_t*)perm;
  auto sm = (const int64_t*)masks;
  auto w = (const __nv_bfloat16*)wl;
  auto sc = (const float*)scale;
  auto sh = (const float*)shift;
  auto ov = (const uint8_t*)out_valid;
  auto o = (float*)out;
  auto s = (cudaStream_t)stream;
#define MSMD_NP(N)                                                          \
  case N:                                                                   \
    return launch<N>(f, cin, vec16, rw, k_out, ta, pm, sm, w, col_blocks,  \
                     upt, cout, sc, sh, relu, ov, o, s);
  switch (np) {
    MSMD_NP(16)
    MSMD_NP(32)
    MSMD_NP(64)
    MSMD_NP(80)
    MSMD_NP(96)
    MSMD_NP(128)
    MSMD_NP(192)
    MSMD_NP(208)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MSMD_NP
}
