// Gather-GEMM sparse convolution over precomputed rulebook rows on the
// bf16 tensor cores, fp32 sums, with the inference epilogue (BN affine,
// ReLU, valid mask) fused in. It serves the forward and, over the dual
// rows, the training backward's input gradient.
//
// Replaces the packed mode of the TPU kernel
// msmdfusion_tpu/ops/sparse/matchconv.py _vgather_kernel (wrapper
// _vgather_conv under MSMD_CONV_DTYPE=bfloat16). That kernel packed bf16
// channel pairs of the features into f32 lanes, unpacked them after the
// gather and ran one bf16 MXU pass against the bf16-rounded weights with an
// fp32 accumulator. The contract it leaves is the rounding, not the
// packing:
//
//   out[r] = epi( sum_t bf16(feats[rows[r, t]]) @ bf16(W[t]) )   fp32 sums
//   epi(v) = valid[r] ? relu?(v * scale + shift) : 0             on fp32
//
// (the scale is never folded into the weights before they are rounded;
// rounding is to nearest even).
//
// Bound on the card: bytes, as chip_smoke.py reckons them: the fp32
// features it rounds (K_in * Cin * 4, read once), the rows and their
// order, the weights, the epilogue's vectors and the fp32 output, against
// 2 * hits * Cin * Cout FLOP at the dense bf16 tensor rate.
//
// Design, against what held the first version at ~54x that bound:
// - Misses staged as zeros: the plan sorts the output rows stably by
//   their tap-hit mask (RowOrder.perm and .masks, built once per plan). A
//   block owns BM = 128 sorted rows, one warp per 16-row slice; each warp
//   ORs its rows' masks (a shuffle), the block ORs the warps'. The block
//   stages only the taps some slice of it hits, and a warp multiplies only
//   the taps its own slice hits. A miss inside a hitting slice is
//   zero-filled by cp.async without being read. Each result row is written
//   to its original position; each row's sum runs over its taps in
//   ascending order.
// - Synchronous scalar gathers: rows arrive through a ring of NS stages
//   of 16-byte cp.async copies (4-byte ones where Cin is not a multiple
//   of 4, as the 5-channel input conv, or the features are not 16-byte
//   aligned), so later taps' gathers are in flight during this tap's
//   products; one barrier per staged chunk.
// - Weights re-rounded per block: the wrapper rounds them to bf16 once per
//   call, as [Ta][Cout padded][Cin padded] (Cin fastest), and the block
//   copies each tap's chunk with cp.async, no conversion.
// - Output tiles of 64 columns: a block owns all of Cout, padded to the
//   next of 16/32/64/80/96/128/192 (wider convs take column blocks of
//   192), so each gathered row is read once per tap.
// - WMMA: products are mma.sync m16n8k16 bf16 with fp32 accumulators; A
//   fragments are rounded from the staged fp32 rows as they are loaded
//   (__floats2bfloat162_rn), B fragments read straight from shared memory.
//   The 16-row granularity of mma.sync is the slice a warp skips by.
// Shared-memory row strides (KC + 8 words for A, KC + 8 halves for B)
// keep both fragment loads free of bank conflicts.
//
// The packed engine's kernel alone: the fp32 rulebook engine's x3 route,
// which instantiated this body with three passes
// (msmd_gather_gemm_conv_x3), has its own Hopper kernel in
// gather_gemm_conv_x3.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;

constexpr int BM = 128;            // sorted output rows per block
constexpr int WARPS = BM / 16;     // one 16-row slice per warp
constexpr int NT = WARPS * 32;     // threads; two per staged row
constexpr int MAX_TAPS = 62;       // the tap-hit mask is an int64
static_assert(NT == 2 * BM, "two threads stage each row");

template <int NP, int KC, int NS>
struct Layout {
  static constexpr int SA = KC + 8;              // fp32 per staged row
  static constexpr int SB = KC + 8;              // bf16 per weight column
  static constexpr int A_BYTES = BM * SA * 4;
  static constexpr int STAGE = A_BYTES + NP * SB * 2;
  static constexpr int BYTES = NS * STAGE;
};

template <int NP, int KC, int VEC, int NS>
__global__ void __launch_bounds__(NT)
gather_conv_bf16_kernel(const float* __restrict__ feats, int cin,
                        const int32_t* __restrict__ rows, int k_out, int ta,
                        const int64_t* __restrict__ perm,
                        const int64_t* __restrict__ masks,
                        const __nv_bfloat16* __restrict__ wt, int n_pad,
                        int kp, int cout, const float* __restrict__ scale,
                        const float* __restrict__ shift, int relu,
                        const uint8_t* __restrict__ out_valid,
                        float* __restrict__ out) {
  using L = Layout<NP, KC, NS>;
  constexpr int NN = NP / 8;                 // n8 tiles per warp
  constexpr int PER_ROW = KC * 4 / VEC;      // copies per staged row
  constexpr int B_PER_COL = KC * 2 / 16;     // copies per weight column
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_orig[BM];
  __shared__ unsigned long long s_slice[WARPS];
  __shared__ int s_taps[64];
  __shared__ int s_ntaps;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int r0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * NP;

  if (tid < BM)
    s_orig[tid] = r0 + tid < k_out ? (int)__ldg(perm + r0 + tid) : -1;
  // this warp's taps: the OR of its slice's 16 masks; the block's: the OR
  // of its slices'
  const int r = r0 + warp * 16 + (lane & 15);
  unsigned long long my_mask =
      r < k_out ? (unsigned long long)__ldg(masks + r) : 0ull;
  for (int off = 8; off > 0; off >>= 1)
    my_mask |= __shfl_xor_sync(0xffffffffu, my_mask, off);
  if (lane == 0) s_slice[warp] = my_mask;
  __syncthreads();
  if (warp == 0) {
    unsigned long long m = lane < WARPS ? s_slice[lane] : 0ull;
    for (int off = 16; off > 0; off >>= 1)
      m |= __shfl_xor_sync(0xffffffffu, m, off);
    if (lane == 0) {
      int n = 0;
      for (; m; m &= m - 1) s_taps[n++] = __ffsll((long long)m) - 1;
      s_ntaps = n;
    }
  }
  __syncthreads();

  const int nkc = kp / KC;
  const int units = s_ntaps * nkc;     // (tap, Cin chunk), taps ascending

  // stage unit u: its gathered rows (zero for a miss and past Cin) and its
  // weight chunk
  auto load = [&](int u, int st) {
    const int t = s_taps[u / nkc];
    const int k0 = (u % nkc) * KC;
    float* as = reinterpret_cast<float*>(smem + st * L::STAGE);
    __nv_bfloat16* bs =
        reinterpret_cast<__nv_bfloat16*>(smem + st * L::STAGE + L::A_BYTES);
    const int m = tid >> 1;
    const int orig = s_orig[m];
    const int row = orig >= 0 ? __ldg(rows + (int64_t)orig * ta + t) : -1;
    const float* src_row = feats + (int64_t)(row < 0 ? 0 : row) * cin;
#pragma unroll
    for (int j = tid & 1; j < PER_ROW; j += 2) {
      const int col = k0 + j * (VEC / 4);
      const bool ok = row >= 0 && col < cin;
      float* dst = as + m * L::SA + j * (VEC / 4);
      if constexpr (VEC == 16) {
        cp_async16(dst, ok ? src_row + col : feats, ok);
      } else {
        cp_async4(dst, ok ? src_row + col : feats, ok);
      }
    }
    const __nv_bfloat16* w = wt + ((int64_t)t * n_pad + n0) * kp + k0;
    for (int e = tid; e < NP * B_PER_COL; e += NT) {
      const int n = e / B_PER_COL, j = e - n * B_PER_COL;
      cp_async16(bs + n * L::SB + j * 8, w + (int64_t)n * kp + j * 8, true);
    }
  };

  float acc[NN][4];
#pragma unroll
  for (int j = 0; j < NN; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

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
    if (!((my_mask >> s_taps[u / nkc]) & 1ull)) continue;
    const int st = u % NS;
    const float* as = reinterpret_cast<const float*>(smem + st * L::STAGE) +
                      (warp * 16 + g) * L::SA + 2 * c;
    const __nv_bfloat16* bs = reinterpret_cast<const __nv_bfloat16*>(
                                  smem + st * L::STAGE + L::A_BYTES) +
                              g * L::SB + 2 * c;
#pragma unroll
    for (int ks = 0; ks < KC; ks += 16) {
      uint32_t a[4];
      float2 v = *reinterpret_cast<const float2*>(as + ks);
      a[0] = pack_bf16(v.x, v.y);
      v = *reinterpret_cast<const float2*>(as + 8 * L::SA + ks);
      a[1] = pack_bf16(v.x, v.y);
      v = *reinterpret_cast<const float2*>(as + ks + 8);
      a[2] = pack_bf16(v.x, v.y);
      v = *reinterpret_cast<const float2*>(as + 8 * L::SA + ks + 8);
      a[3] = pack_bf16(v.x, v.y);
#pragma unroll
      for (int j = 0; j < NN; ++j) {
        const __nv_bfloat16* q = bs + j * 8 * L::SB + ks;
        uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(q),
                         *reinterpret_cast<const uint32_t*>(q + 8)};
        mma(acc[j], a, b);
      }
    }
  }

  // epilogue on the fp32 sums; each sorted row to its original position
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int orig = s_orig[warp * 16 + g + 8 * h];
    if (orig < 0) continue;
    const bool keep = out_valid == nullptr || out_valid[orig];
    float* dst = out + (int64_t)orig * cout;
#pragma unroll
    for (int j = 0; j < NN; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + j * 8 + 2 * c + e;
        if (n >= cout) continue;
        float v = acc[j][2 * h + e];
        if (scale != nullptr) v = v * __ldg(scale + n);
        if (shift != nullptr) v = v + __ldg(shift + n);
        if (relu) v = fmaxf(v, 0.f);
        dst[n] = keep ? v : 0.f;
      }
  }
}

template <int NP, int KC, int VEC>
int launch(const float* feats, int cin, const int32_t* rows, int k_out,
           int ta, const int64_t* perm, const int64_t* masks,
           const __nv_bfloat16* wt, int kp, int cout, const float* scale,
           const float* shift, int relu, const uint8_t* out_valid,
           float* out, cudaStream_t stream) {
  constexpr int NS = KC == 16 ? 4 : 3;
  using L = Layout<NP, KC, NS>;
  auto kernel = gather_conv_bf16_kernel<NP, KC, VEC, NS>;
  if (L::BYTES > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return (int)err;
  }
  const int col_blocks = (cout + NP - 1) / NP;
  dim3 grid((k_out + BM - 1) / BM, col_blocks);
  kernel<<<grid, NT, L::BYTES, stream>>>(
      feats, cin, rows, k_out, ta, perm, masks, wt, col_blocks * NP,
      kp, cout, scale, shift, relu, out_valid, out);
  return (int)cudaGetLastError();
}

// kc 32 with 16-byte copies; otherwise 16-deep chunks (kp, a multiple of
// 32 or 16, is a multiple of 16 either way)
template <int NP>
int dispatch_kc(int kc, bool vec16, const float* feats, int cin,
                const int32_t* rows, int k_out, int ta, const int64_t* perm,
                const int64_t* masks, const __nv_bfloat16* wt, int kp,
                int cout, const float* scale, const float* shift, int relu,
                const uint8_t* out_valid, float* out, cudaStream_t s) {
  if (kc == 32 && vec16)
    return launch<NP, 32, 16>(feats, cin, rows, k_out, ta, perm, masks,
                              wt, kp, cout, scale, shift, relu, out_valid,
                              out, s);
  if (vec16)
    return launch<NP, 16, 16>(feats, cin, rows, k_out, ta, perm, masks,
                              wt, kp, cout, scale, shift, relu, out_valid,
                              out, s);
  return launch<NP, 16, 4>(feats, cin, rows, k_out, ta, perm, masks, wt,
                           kp, cout, scale, shift, relu, out_valid, out, s);
}

}  // namespace

// wt: [Ta][ceil(cout / np) * np][kp] bf16, the weights rounded once and
// zero-padded; np one of 16/32/64/80/96/128/192; kc (16 or 32) divides kp
// and kp >= cin; perm and masks [k_out] (int64) from the plan's RowOrder.
extern "C" int msmd_gather_gemm_conv_bf16(
    const void* feats, int cin, const void* rows, int k_out, int ta,
    const void* perm, const void* masks, const void* wt, int np,
    int kc, int kp, int cout, const void* scale, const void* shift, int relu,
    const void* out_valid, void* out, void* stream) {
  if ((kc != 16 && kc != 32) || kp % kc != 0 || kp < cin || ta > MAX_TAPS ||
      cin < 1)
    return (int)cudaErrorInvalidValue;
  if (k_out == 0 || cout == 0) return (int)cudaGetLastError();
  const bool vec16 = cin % 4 == 0 && (uintptr_t)feats % 16 == 0;
  auto f = (const float*)feats;
  auto rw = (const int32_t*)rows;
  auto pm = (const int64_t*)perm;
  auto sm = (const int64_t*)masks;
  auto w = (const __nv_bfloat16*)wt;
  auto sc = (const float*)scale;
  auto sh = (const float*)shift;
  auto ov = (const uint8_t*)out_valid;
  auto o = (float*)out;
  auto s = (cudaStream_t)stream;
#define MSMD_NP(N)                                                          \
  case N:                                                                   \
    return dispatch_kc<N>(kc, vec16, f, cin, rw, k_out, ta, pm, sm, w, kp,  \
                          cout, sc, sh, relu, ov, o, s);
  switch (np) {
    MSMD_NP(16)
    MSMD_NP(32)
    MSMD_NP(64)
    MSMD_NP(80)
    MSMD_NP(96)
    MSMD_NP(128)
    MSMD_NP(192)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MSMD_NP
}
