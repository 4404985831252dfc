// Weight gradient of the fp32 rulebook engine's default sparse convolution
// (the x3 route) on Hopper's warpgroup tensor cores, with a deterministic
// reduction.
//
// Replaces the with_dw accumulator of the fp32 mode of the TPU kernel
// msmdfusion_tpu/ops/sparse/matchconv.py _vgather_kernel (the dw scratch
// that _pallas_bwd reads) under its default gemm_mode() 'x3'
// (matchconv.py:1151-1168): both operands split into bf16 hi + lo, three
// tensor-core products with fp32 sums, lo.lo dropped:
//
//   dw[t] = sum_p hi(x)^T (x) hi(g) + hi(x)^T (x) lo(g) + lo(x)^T (x) hi(g)
//   x = feats[pair_in[p]], g = g[pair_out[p]] over tap t's hit pairs p
//   hi(v) = bf16_rn(v), lo(v) = bf16_rn(v - float(hi(v)))
//
// dw [Ta, Cin, Cout]; feats [K_in, Cin]; g [K_out, Cout], the gradient of
// the conv's output; the pairs from the plan's RowOrder.
//
// Bound on the card: operations, as chip_smoke.py reckons them: 3 x 2 *
// hits * Cin * Cout FLOP at the dense bf16 tensor rate, against the fp32
// operands (read once), the rows and dw itself.
//
// Design (sm_90a), against what held the mma.sync version at ~10x that
// bound (64-pair stages, a block-wide barrier each, tiles of at most 128
// so that a 192-wide conv took 2 x 2 tiles with ~44% padding):
// - A block owns one chunk of one tap's pairs, up to three 64-row slabs of
//   Cin (one consumer warpgroup each) and one column block of Cout of NB
//   columns: each pair's rows are gathered once per column block. NB is
//   at most 96 beside three slabs and 128 beside two (the registers of the
//   running and the fresh accumulators); a 192-wide Cout takes two column
//   blocks of 96 (matchconv.conv_dw_x3_launch).
// - A producer warpgroup gathers each stage's KP = 64 pairs (their input
//   rows X over the block's slabs and gradient rows G over its columns),
//   one row a thread, each by one bulk copy of the TMA unit: 16-byte
//   cp.async pieces cost more issue slots than the copies take (the
//   kernel ran ~2x slower on them); 4-byte cp.async where a width is not a
//   multiple of 4 or an operand is not 16-byte aligned. Zeros for pairs
//   past the chunk; all completing on the stage's full mbarrier, which
//   consumers free on its empty one. Each thread loads its row index four
//   stages ahead. setmaxnreg hands the producer's registers to the
//   consumers. One block fills an SM, two at one slab up to 96 columns.
// - The product: wgmma m64nNk16 with A = X^T from registers, split into hi
//   and lo from the staged fp32 rows (row stride = 4 mod 32 words: the
//   transposed fragment loads are free of bank conflicts), and B = G's hi
//   and lo in shared memory, which the consumers convert once per stage
//   into wgmma's K-major core-matrix order (two buffers, one named barrier
//   among the consumers a stage). Per 16 pairs a fresh accumulator takes
//   the three products (a chain of 3 wgmma, 48 products deep), added to
//   the running fp32 sum by one fp32 add (the tensor cores round their
//   sums toward zero; a longer chain biases the sums: see CHAIN in
//   gather_gemm_conv_x3.cu).
// - Deterministic: every chunk writes its own fp32 partial; a second
//   kernel sums each tap's partials in chunk order. No float atomics, so
//   two calls give the same bits. The chunking is a function of the shapes
//   and the plan only (matchconv.conv_dw_x3_launch).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "wgmma_x3.cuh"

namespace {

using namespace mma_bf16;
using namespace wgmma_x3;

constexpr int KP = 64;               // pairs per stage: 16-deep steps
static_assert(KP % 16 == 0 && 2 * KP <= 128, "one index a producer thread");
constexpr int AHEAD = 4;             // stages the row indices load ahead
constexpr int MAX_SLABS = 3;         // 64-row slabs of Cin per block
constexpr int MAX_NS = 8;
// dynamic shared memory of one block an SM (227 KB a block at most), and
// of each of two (228 KB an SM, 1 KB of it reserved a block), static aside
constexpr int ONE_SMEM = 232448 - 2048;
constexpr int TWO_SMEM = 233472 / 2 - 4096;
constexpr int PRODUCER_REGS = 56;

template <int NB>
struct Dw {
  // three consumer warpgroups up to 96 columns, two at 128
  static constexpr int SLABS = NB > 96 ? 2 : 3;
  static constexpr int THREADS = (SLABS + 1) * 128;
  static constexpr int CONSUMER_REGS = NB > 96 ? 224 : 152;
  static constexpr int GS = NB + 4;                  // fp32 per staged G row
  static constexpr int B_BYTES = KP * NB * 2 * 2;    // hi + lo of G
  // the registers a thread starts with (ptxas takes all the launch bounds
  // allow); setmaxnreg moves registers between a block's own warps only
  static constexpr int ENTRY_REGS = 65536 / THREADS / 8 * 8;
  static_assert(128 * PRODUCER_REGS + SLABS * 128 * CONSUMER_REGS <=
                    THREADS * ENTRY_REGS,
                "the consumers take no more than the producer gives up");
};

// the stage ring's bytes at `slabs` slabs of X beside NB columns of G
__host__ __device__ inline int dw_stage_bytes(int slabs, int gs) {
  return KP * (slabs * 64 + 4 + gs) * 4;
}

// by one warp: the pair range [p0, p1) of chunk b, each tap's pairs cut in
// chunks of `chunk`, taps ascending (matchconv.dw_x3_chunks); lane l
// counts the chunks of taps l and l + 32 (ta <= 64), a scan over the lanes
// places them
__device__ __forceinline__ void find_chunk(const int32_t* tap_start, int ta,
                                           int chunk, int b, int lane,
                                           int* range) {
  int begin[2], end[2], inc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int u = lane + 32 * h;
    begin[h] = u < ta ? __ldg(tap_start + u) : 0;
    end[h] = u < ta ? __ldg(tap_start + u + 1) : 0;
    inc[h] = (end[h] - begin[h] + chunk - 1) / chunk;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, inc[h], off);
      if (lane >= off) inc[h] += v;
    }
  }
  inc[1] += __shfl_sync(0xffffffffu, inc[0], 31);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = (end[h] - begin[h] + chunk - 1) / chunk;
    if (b >= inc[h] - n && b < inc[h]) {
      range[0] = begin[h] + (b - inc[h] + n) * chunk;
      range[1] = min(end[h], range[0] + chunk);
    }
  }
}

template <int NB>
__global__ void __launch_bounds__(Dw<NB>::THREADS, 1)
conv_dw_x3_kernel(const float* __restrict__ feats, int cin,
                  const float* __restrict__ g, int cout, int ta,
                  int x_bulk, int g_bulk,
                  const int32_t* __restrict__ pair_in,
                  const int32_t* __restrict__ pair_out,
                  const int32_t* __restrict__ tap_start, int chunk,
                  int slabs, int ns, float* __restrict__ partials) {
  using D = Dw<NB>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[MAX_NS];
  __shared__ __align__(8) uint64_t empty[MAX_NS];
  __shared__ int s_range[2];                 // the chunk's pairs

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int consumers = slabs * 128;
  const int xs_stride = slabs * 64 + 4;             // fp32 per X row
  const int stage_bytes = dw_stage_bytes(slabs, D::GS);
  const int c0 = blockIdx.y * slabs * 64;           // the block's Cin
  const int n0 = blockIdx.z * NB;                   // and Cout
  const int cin_b = min(cin - c0, slabs * 64);
  const int cout_b = min(cout - n0, NB);
  if (warp == 0)
    find_chunk(tap_start, ta, chunk, blockIdx.x, lane, s_range);
  if (tid == 32) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(&full[s], 128);              // the producer's copies
      mbar_init(&empty[s], slabs * 4);       // one per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int p0 = s_range[0], p1 = s_range[1];
  const int stages = (p1 - p0 + KP - 1) / KP;

  if (warp >= slabs * 4) {
    // producer warpgroup: each stage's X and G rows, thread pt < KP X row
    // pt, KP <= pt < 2 KP G row pt - KP: by one bulk copy of the TMA unit
    // where the row is a multiple of 16 bytes and 16-byte aligned (zeros
    // written for a pair past the chunk), else by 4-byte cp.async (zeros
    // copied)
    setmaxnreg_dec<PRODUCER_REGS>();
    const int pt = tid - consumers;
    const bool x_row = pt < KP;
    const int k = x_row ? pt : pt - KP;
    float* const slot0 =
        reinterpret_cast<float*>(smem) +
        (x_row ? k * xs_stride : KP * xs_stride + k * D::GS);
    const int floats = x_row ? cin_b : cout_b;
    const float* const base = x_row ? feats + c0 : g + n0;
    const int width = x_row ? cin : cout;
    const bool bulk = x_row ? x_bulk : g_bulk;
    // this thread's row index of each stage (-1 past the chunk), loaded
    // AHEAD stages ahead
    auto pair_row = [&](int u) {
      const int p = p0 + u * KP + k;
      if (u >= stages || p >= p1 || pt >= 2 * KP) return -1;
      return x_row ? __ldg(pair_in + p) : __ldg(pair_out + p);
    };
    int ahead[AHEAD];
#pragma unroll
    for (int d = 0; d < AHEAD; ++d) ahead[d] = pair_row(d);
    for (int u = 0; u < stages; ++u) {
      const int s = u % ns;
      const int row = ahead[0];
#pragma unroll
      for (int d = 0; d + 1 < AHEAD; ++d) ahead[d] = ahead[d + 1];
      ahead[AHEAD - 1] = pair_row(u + AHEAD);
      mbar_wait(&empty[s], ((u / ns) & 1) ^ 1);
      float* dst = slot0 + s * (stage_bytes / 4);
      const float* src = base + (int64_t)(row < 0 ? 0 : row) * width;
      if (pt >= 2 * KP) {
        mbar_arrive(&full[s]);
      } else if (bulk) {
        if (row < 0)
          for (int i = 0; i < floats; i += 4)
            *reinterpret_cast<float4*>(dst + i) =
                make_float4(0.f, 0.f, 0.f, 0.f);
        const uint32_t bytes = row < 0 ? 0u : floats * 4u;
        mbar_arrive_expect_tx(&full[s], bytes);
        if (bytes) bulk_copy_g2s(dst, src, bytes, &full[s]);
      } else {
        for (int i = 0; i < floats; ++i)
          cp_async4(dst + i, row < 0 ? base : src + i, row >= 0);
        cp_async_mbar_arrive(&full[s]);
      }
    }
  } else {
    // consumer warpgroup wg: Cin rows c0 + 64 wg .. + 63, all NB columns
    setmaxnreg_inc<D::CONSUMER_REGS>();
    const int wg = warp / 4, wi = warp % 4;
    const int gq = lane / 4, c = lane % 4;
    unsigned char* bslots = smem + ns * stage_bytes;
    float acc[NB / 2];
    float fresh[NB / 2];
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) acc[i] = fresh[i] = 0.f;

    for (int u = 0; u < stages; ++u) {
      const int s = u % ns;
      mbar_wait(&full[s], (u / ns) & 1);
      const float* xs = reinterpret_cast<const float*>(smem + s * stage_bytes);
      const float* gs = xs + KP * xs_stride;
      __nv_bfloat16* bs =
          reinterpret_cast<__nv_bfloat16*>(bslots + (u & 1) * D::B_BYTES);
      // G's stage, converted once, a core matrix a warp at a time: each
      // 16-deep step is [hi, lo][NB / 8][2][8][8] (wgmma_x3.cuh), lane l
      // the pair of k (2 (l % 4), + 1) of column l / 4, one 32-bit word
      // (consecutive lanes, consecutive words; the reads free of bank
      // conflicts too: G's row stride is 8 mod 32 words over 2 rows)
      for (int cm = warp; cm < KP / 16 * (NB / 4); cm += slabs * 4) {
        const int step = cm / (NB / 4), core = cm % (NB / 4);
        const int kh = core / (NB / 8), ng = core % (NB / 8);
        const int k = 16 * step + 8 * kh + 2 * (lane % 4);
        const int n = 8 * ng + lane / 4;
        uint32_t hi, lo;
        split_bf16(gs[k * D::GS + n], gs[(k + 1) * D::GS + n], &hi, &lo);
        uint32_t* words = reinterpret_cast<uint32_t*>(bs + step * NB * 32);
        words[(ng * 2 + kh) * 32 + lane] = hi;
        words[NB * 8 + (ng * 2 + kh) * 32 + lane] = lo;
      }
      fence_proxy_async();
      named_sync(1, consumers);
      // A = X^T: Cin rows gq and gq + 8 of this warp's 16, pairs 2c, 2c + 1
      // (and + 8) of each 16-deep step
      const float* x0 = xs + 2 * c * xs_stride + wg * 64 + wi * 16 + gq;
      const uint32_t b0 = smem_addr(bs);
#pragma unroll
      for (int q = 0; q < KP / 16; ++q) {
        const float* x = x0 + q * 16 * xs_stride;
        uint32_t ahi[4], alo[4];
        split_bf16(x[0], x[xs_stride], &ahi[0], &alo[0]);
        split_bf16(x[8], x[xs_stride + 8], &ahi[1], &alo[1]);
        split_bf16(x[8 * xs_stride], x[9 * xs_stride], &ahi[2], &alo[2]);
        split_bf16(x[8 * xs_stride + 8], x[9 * xs_stride + 8], &ahi[3],
                   &alo[3]);
        const uint32_t b = b0 + q * NB * 64;
        const uint64_t d_hi = b_desc(b), d_lo = b_desc(b + NB * 32);
        wgmma_fence();
        Wgmma<NB>::mma(fresh, ahi, d_hi, 0);
        Wgmma<NB>::mma(fresh, ahi, d_lo, 1);
        Wgmma<NB>::mma(fresh, alo, d_hi, 1);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < NB / 2; ++i) {
          fence_operand(fresh[i]);
          acc[i] += fresh[i];
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // this chunk's partial: rows c0 + 64 wg + 16 wi + gq (+ 8), NB columns
    float* dst = partials + (int64_t)blockIdx.x * cin * cout;
#pragma unroll
    for (int j = 0; j < NB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = c0 + wg * 64 + wi * 16 + gq + 8 * (e / 2);
        const int n = n0 + j * 8 + 2 * c + (e & 1);
        if (m < cin && n < cout && m < c0 + cin_b)
          dst[(int64_t)m * cout + n] = acc[j * 4 + e];
      }
  }
}

// dw[t] = sum over tap t's chunks, in chunk order, of their partials
__global__ void conv_dw_x3_reduce_kernel(const float* __restrict__ partials,
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

template <int NB>
int launch(const float* feats, int cin, const float* g, int cout, int ta,
           bool x_bulk, bool g_bulk, const int32_t* pi, const int32_t* po,
           const int32_t* ts, int slabs, int col_blocks, int chunk,
           int n_chunks, float* partials, cudaStream_t stream) {
  using D = Dw<NB>;
  if (slabs > D::SLABS) return (int)cudaErrorInvalidValue;
  const int stage = dw_stage_bytes(slabs, D::GS);
  // two blocks an SM where one slab's registers and two stages allow (each
  // one's prologue and first gathers overlap the other's products)
  const bool two = slabs == 1 && NB <= 96 &&
                   (TWO_SMEM - 2 * D::B_BYTES) / stage >= 2;
  int ns = ((two ? TWO_SMEM : ONE_SMEM) - 2 * D::B_BYTES) / stage;
  ns = ns < MAX_NS ? ns : MAX_NS;
  if (ns < 2) return (int)cudaErrorInvalidValue;
  const int bytes = ns * stage + 2 * D::B_BYTES;
  auto kernel = conv_dw_x3_kernel<NB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int groups = (cin + slabs * 64 - 1) / (slabs * 64);
  dim3 grid(n_chunks, groups, col_blocks);
  kernel<<<grid, (slabs + 1) * 128, bytes, stream>>>(
      feats, cin, g, cout, ta, x_bulk, g_bulk, pi, po, ts, chunk, slabs, ns,
      partials);
  return (int)cudaGetLastError();
}

}  // namespace

// pair_in, pair_out [hits] and tap_start [Ta + 1] from the plan's RowOrder
// (Ta at most 64); slabs (1-3; at most 2 where nb is 128) 64-row slabs of
// Cin per block, nb (16/32/48/64/80/96/128) columns of Cout per block,
// col_blocks * nb >= Cout; chunk pairs of a tap per block, n_chunks = sum
// over taps of ceil(hits_t / chunk) (matchconv.conv_dw_x3_launch);
// partials: [max(n_chunks, 1), Cin, Cout] scratch.
extern "C" int msmd_conv_dw_x3(const void* feats, int cin, const void* g,
                               int cout, int ta, const void* pair_in,
                               const void* pair_out, const void* tap_start,
                               int slabs, int nb, int col_blocks, int chunk,
                               int n_chunks, void* partials, void* dw,
                               void* stream) {
  if (chunk < 1 || n_chunks < 0 || partials == nullptr || slabs < 1 ||
      slabs > MAX_SLABS || col_blocks < 1 || col_blocks * nb < cout ||
      ta > 64)
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
    // rows a bulk copy takes: whole 16-byte pieces, 16-byte aligned
    const bool x_bulk = cin % 4 == 0 && (uintptr_t)feats % 16 == 0;
    const bool g_bulk = cout % 4 == 0 && (uintptr_t)g % 16 == 0;
    int err;
    switch (nb) {
#define MSMD_NB(N)                                                         \
  case N:                                                                  \
    err = launch<N>(f, cin, gg, cout, ta, x_bulk, g_bulk, pi, po, ts,      \
                    slabs, col_blocks, chunk, n_chunks, part, s);          \
    break;
      MSMD_NB(16)
      MSMD_NB(32)
      MSMD_NB(48)
      MSMD_NB(64)
      MSMD_NB(80)
      MSMD_NB(96)
      MSMD_NB(128)
#undef MSMD_NB
      default:
        return (int)cudaErrorInvalidValue;
    }
    if (err != 0) return err;
  }
  const int threads = 256;
  const int64_t blocks = (ta * tile_size + threads - 1) / threads;
  conv_dw_x3_reduce_kernel<<<(unsigned)blocks, threads, 0, s>>>(
      part, ts, ta, chunk, tile_size, (float*)dw);
  return (int)cudaGetLastError();
}
