// Gather-GEMM sparse convolution over precomputed rulebook rows, fp32,
// with the inference epilogue (BN affine, ReLU, valid mask) fused in.
//
// Replaces the TPU kernel msmdfusion_tpu/ops/sparse/matchconv.py
// _vgather_kernel (wrapper _vgather_conv, forward fp32 mode). That kernel
// DMA'd a slab of transposed input features into VMEM per tile and tap
// group, gathered the matched columns with lane butterflies and ran a
// bf16 hi/lo x3 MXU product. Here a block owns BM output rows and BN
// output channels and walks the taps:
//
//   out[r] = epi( sum_t feats[rows[r, t]] @ W[t] ),  rows[r, t] = -1: miss
//   epi(v) = valid[r] ? relu?(v * scale + shift) : 0
//
// Per tap the block stages the BM gathered input rows (zero for a miss)
// and the [Cin, BN] weight slice in shared memory, in BK-deep chunks of
// Cin, and every thread accumulates a TM x TN tile with FFMA in fp32.
// A tap that no row of the block hits is skipped by a block-wide vote.
// No TF32 and no bf16 anywhere: the contract is fp32 accumulation.
//
// Bound on the card: at the encoder's widths (Cin, Cout <= 128) the
// useful work is 2 * hits * Cin * Cout FLOP against ~(hits * Cin + K_out *
// Cout) * 4 bytes, ~Cout/2 FLOP per byte, which is above the fp32 CUDA-core
// ridge (67 TFLOP/s / 3.35 TB/s = 20) only for Cout >= 64: the narrow
// stages are bound by bytes, the wide ones by fp32 operations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
gather_gemm_conv_kernel(const float* __restrict__ feats, int cin,
                        const int32_t* __restrict__ rows, int k_out, int ta,
                        const float* __restrict__ weights, int cout,
                        const float* __restrict__ scale,
                        const float* __restrict__ shift, int relu,
                        const uint8_t* __restrict__ out_valid,
                        float* __restrict__ out) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int TX = BN / TN;
  __shared__ int s_rows[BM];
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int r0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

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
        As[k][m] = (row >= 0 && k < kmax)
                       ? __ldg(feats + (int64_t)row * cin + k0 + k)
                       : 0.f;
      }
      for (int e = tid; e < BK * BN; e += NT) {
        int k = e / BN;
        int n = e - k * BN;
        Bs[k][n] = (k < kmax && n0 + n < cout)
                       ? __ldg(w_t + (int64_t)(k0 + k) * cout + n0 + n)
                       : 0.f;
      }
      __syncthreads();
      for (int kk = 0; kk < kmax; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int r = r0 + ty * TM + i;
    if (r >= k_out) continue;
    bool keep = out_valid == nullptr || out_valid[r];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int n = n0 + tx * TN + j;
      if (n >= cout) continue;
      float v = acc[i][j];
      if (scale != nullptr) v = v * __ldg(scale + n);
      if (shift != nullptr) v = v + __ldg(shift + n);
      if (relu) v = fmaxf(v, 0.f);
      out[(int64_t)r * cout + n] = keep ? v : 0.f;
    }
  }
}

template <int BM, int BN, int TM, int TN>
void launch(const float* feats, int cin, const int32_t* rows, int k_out,
            int ta, const float* weights, int cout, const float* scale,
            const float* shift, int relu, const uint8_t* out_valid,
            float* out, cudaStream_t stream) {
  dim3 grid((k_out + BM - 1) / BM, (cout + BN - 1) / BN);
  dim3 block((BM / TM) * (BN / TN));
  gather_gemm_conv_kernel<BM, BN, TM, TN><<<grid, block, 0, stream>>>(
      feats, cin, rows, k_out, ta, weights, cout, scale, shift, relu,
      out_valid, out);
}

}  // namespace

extern "C" int msmd_gather_gemm_conv(const void* feats, int cin,
                                     const void* rows, int k_out, int ta,
                                     const void* weights, int cout,
                                     const void* scale, const void* shift,
                                     int relu, const void* out_valid,
                                     void* out, void* stream) {
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
      launch<64, 16, 4, 1>(f, cin, rw, k_out, ta, w, cout, sc, sh, relu, ov,
                           o, s);
    } else if (cout <= 32) {
      launch<64, 32, 4, 2>(f, cin, rw, k_out, ta, w, cout, sc, sh, relu, ov,
                           o, s);
    } else {
      launch<64, 64, 4, 4>(f, cin, rw, k_out, ta, w, cout, sc, sh, relu, ov,
                           o, s);
    }
  }
  return (int)cudaGetLastError();
}
