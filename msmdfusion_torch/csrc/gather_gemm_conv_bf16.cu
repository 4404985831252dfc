// Gather-GEMM sparse convolution over precomputed rulebook rows on the
// bf16 tensor cores, fp32 sums, with the inference epilogue (BN affine,
// ReLU, valid mask) fused in.
//
// Replaces the packed mode of the TPU kernel
// msmdfusion_tpu/ops/sparse/matchconv.py _vgather_kernel (wrapper
// _vgather_conv under MSMD_CONV_DTYPE=bfloat16). That kernel packed bf16
// channel pairs of the features into f32 lanes (half the slab DMA and the
// butterfly gather's instructions), unpacked them after the gather and ran
// one bf16 MXU pass against the bf16-rounded weights with an fp32
// accumulator. The contract it leaves is the rounding, not the packing:
//
//   out[r] = epi( sum_t bf16(feats[rows[r, t]]) @ bf16(W[t]) )   fp32 sums
//   epi(v) = valid[r] ? relu?(v * scale + shift) : 0             on fp32
//
// (the scale is never folded into the weights before they are rounded).
// A block owns BM = 64 output rows and BN output channels, four warps of
// 16 rows each. Per tap it stages the 64 gathered input rows, rounded to
// bf16 with __float2bfloat16_rn on the way into shared memory (zero for a
// miss and for the channels past Cin: Cin 5 pads to 16), and the [Cin, BN]
// weight slice rounded the same way, in BK = 32-deep chunks; each warp
// multiplies its 16-row slice by the slice's BN / 16 column tiles with
// WMMA 16x16x16 bf16 fragments into fp32 accumulators. A tap that no row of
// the block hits is skipped by a block-wide vote. The accumulators pass
// through shared memory for the epilogue, which writes rows coalesced.
//
// Bound on the card: 2 * hits * Cin * Cout FLOP over the dense bf16
// tensor-core rate (989 TFLOP/s) is far below the bytes it must read, the
// fp32 features it rounds on load (~hits * Cin * 4 bytes through the
// gather, at least K_in * Cin * 4) and the fp32 output: bound by bytes.
// This first version runs WMMA (mma.sync) rather than wgmma and TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64;
constexpr int BK = 32;
constexpr int WARPS = BM / 16;
constexpr int NT = WARPS * 32;

template <int BN>
__global__ void __launch_bounds__(NT)
gather_conv_bf16_kernel(const float* __restrict__ feats, int cin,
                        const int32_t* __restrict__ rows, int k_out, int ta,
                        const float* __restrict__ weights, int cout,
                        const float* __restrict__ scale,
                        const float* __restrict__ shift, int relu,
                        const uint8_t* __restrict__ out_valid,
                        float* __restrict__ out) {
  constexpr int NF = BN / 16;   // accumulator tiles per warp
  __shared__ int s_rows[BM];
  __shared__ __align__(32) __nv_bfloat16 As[BM * BK];   // [row][k]
  __shared__ __align__(32) __nv_bfloat16 Bs[BK * BN];   // [k][col]
  __shared__ __align__(32) float Cs[BM * BN];           // [row][col]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int r0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int t = 0; t < ta; ++t) {
    int hit = 0;
    if (tid < BM) {
      int r = r0 + tid;
      int row = (r < k_out) ? __ldg(rows + (int64_t)r * ta + t) : -1;
      s_rows[tid] = row;
      hit = row >= 0;
    }
    if (!__syncthreads_or(hit)) continue;
    const float* w_t = weights + (int64_t)t * cin * cout;
    for (int k0 = 0; k0 < cin; k0 += BK) {
      const int kmax = min(BK, cin - k0);
      for (int e = tid; e < BM * BK; e += NT) {
        int m = e / BK;
        int k = e - m * BK;
        int row = s_rows[m];
        float v = (row >= 0 && k < kmax)
                      ? __ldg(feats + (int64_t)row * cin + k0 + k)
                      : 0.f;
        As[e] = __float2bfloat16_rn(v);
      }
      for (int e = tid; e < BK * BN; e += NT) {
        int k = e / BN;
        int n = e - k * BN;
        float v = (k < kmax && n0 + n < cout)
                      ? __ldg(w_t + (int64_t)(k0 + k) * cout + n0 + n)
                      : 0.f;
        Bs[e] = __float2bfloat16_rn(v);
      }
      __syncthreads();
      for (int kk = 0; kk < kmax; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, As + warp * 16 * BK + kk, BK);
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> b;
          wmma::load_matrix_sync(b, Bs + kk * BN + j * 16, BN);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int j = 0; j < NF; ++j)
    wmma::store_matrix_sync(Cs + warp * 16 * BN + j * 16, acc[j], BN,
                            wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += NT) {
    int m = e / BN;
    int n = e - m * BN;
    int r = r0 + m;
    int c = n0 + n;
    if (r >= k_out || c >= cout) continue;
    float v = Cs[e];
    if (scale != nullptr) v = v * __ldg(scale + c);
    if (shift != nullptr) v = v + __ldg(shift + c);
    if (relu) v = fmaxf(v, 0.f);
    bool keep = out_valid == nullptr || out_valid[r];
    out[(int64_t)r * cout + c] = keep ? v : 0.f;
  }
}

template <int BN>
void launch(const float* feats, int cin, const int32_t* rows, int k_out,
            int ta, const float* weights, int cout, const float* scale,
            const float* shift, int relu, const uint8_t* out_valid,
            float* out, cudaStream_t stream) {
  dim3 grid((k_out + BM - 1) / BM, (cout + BN - 1) / BN);
  gather_conv_bf16_kernel<BN><<<grid, NT, 0, stream>>>(
      feats, cin, rows, k_out, ta, weights, cout, scale, shift, relu,
      out_valid, out);
}

}  // namespace

extern "C" int msmd_gather_gemm_conv_bf16(const void* feats, int cin,
                                          const void* rows, int k_out,
                                          int ta, const void* weights,
                                          int cout, const void* scale,
                                          const void* shift, int relu,
                                          const void* out_valid, void* out,
                                          void* stream) {
  if (k_out > 0 && cout > 0) {
    auto f = (const float*)feats;
    auto rw = (const int32_t*)rows;
    auto w = (const float*)weights;
    auto sc = (const float*)scale;
    auto sh = (const float*)shift;
    auto ov = (const uint8_t*)out_valid;
    auto o = (float*)out;
    auto s = (cudaStream_t)stream;
    if (cout <= 16) {
      launch<16>(f, cin, rw, k_out, ta, w, cout, sc, sh, relu, ov, o, s);
    } else if (cout <= 32) {
      launch<32>(f, cin, rw, k_out, ta, w, cout, sc, sh, relu, ov, o, s);
    } else {
      launch<64>(f, cin, rw, k_out, ta, w, cout, sc, sh, relu, ov, o, s);
    }
  }
  return (int)cudaGetLastError();
}
