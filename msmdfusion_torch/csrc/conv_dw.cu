// Weight gradient of the gather-GEMM sparse convolution, fp32, with a
// deterministic reduction over the rulebook's rows.
//
// Replaces the with_dw accumulator of the TPU kernel
// msmdfusion_tpu/ops/sparse/matchconv.py _vgather_kernel (the dw scratch
// that _pallas_bwd reads), and the _dw_from_rows einsum it falls back to:
//
//   dw[t] = sum_o feats[rows[o, t]]^T (x) g[o]      rows[o, t] = -1: miss
//
// dw [Ta, Cin, Cout]; feats [K_in, Cin]; rows [K_out, Ta] (the forward
// rulebook); g [K_out, Cout], the gradient of the conv's output. The TPU
// kernel carried the dw sum in VMEM scratch across its sequential grid.
// Here a block owns one tap, one BM x BN tile of (Cin, Cout) and one chunk
// of the output rows: per BK rows it stages the gathered input rows (zero
// for a miss) and the matching g rows in shared memory, and every thread
// accumulates a TM x TN tile with FFMA in fp32. A BK-row step that no row
// of the block hits is skipped by a block-wide vote. The per-chunk
// partials [n_chunks, Ta, Cin, Cout] are then summed in chunk order by a
// second kernel: no float atomics, so the result is the same on every run.
// With one chunk the first kernel writes dw itself. (The packed bf16
// mode's weight gradient is conv_dw_bf16.cu.)
//
// Bound on the card: 2 * hits * Cin * Cout FLOP against (K_in * Cin +
// K_out * Ta + K_out * Cout + Ta * Cin * Cout) * 4 bytes, the same
// operations as the forward conv: the narrow convs are bound by bytes, the
// wide ones (Cin, Cout >= 64) by fp32 operations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
conv_dw_kernel(const float* __restrict__ feats, int cin,
               const int32_t* __restrict__ rows, int k_out, int ta,
               const float* __restrict__ g, int cout, int chunk_rows,
               float* __restrict__ out) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int TX = BN / TN;
  __shared__ int s_rows[BK];
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int chunk = blockIdx.x / ta;
  const int t = blockIdx.x - chunk * ta;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.z * BN;
  const int o_begin = chunk * chunk_rows;
  const int o_end = min(k_out, o_begin + chunk_rows);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int o0 = o_begin; o0 < o_end; o0 += BK) {
    int hit = 0;
    if (tid < BK) {
      int o = o0 + tid;
      int row = (o < o_end) ? __ldg(rows + (int64_t)o * ta + t) : -1;
      s_rows[tid] = row;
      hit = row >= 0;
    }
    if (!__syncthreads_or(hit)) continue;
    for (int e = tid; e < BK * BM; e += NT) {
      int k = e / BM;
      int m = e - k * BM;
      int row = s_rows[k];
      As[k][m] = (row >= 0 && m0 + m < cin)
                     ? __ldg(feats + (int64_t)row * cin + m0 + m)
                     : 0.f;
    }
    for (int e = tid; e < BK * BN; e += NT) {
      int k = e / BN;
      int n = e - k * BN;
      Bs[k][n] = (s_rows[k] >= 0 && n0 + n < cout)
                     ? __ldg(g + (int64_t)(o0 + k) * cout + n0 + n)
                     : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
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

  // out is [n_chunks, Ta, Cin, Cout]; with one chunk, dw itself
  float* dst = out + ((int64_t)chunk * ta + t) * cin * cout;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int m = m0 + ty * TM + i;
    if (m >= cin) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int n = n0 + tx * TN + j;
      if (n < cout) dst[(int64_t)m * cout + n] = acc[i][j];
    }
  }
}

// dw[e] = sum over chunks c, in order, of partials[c, e]
__global__ void conv_dw_reduce_kernel(const float* __restrict__ partials,
                                      int n_chunks, int64_t size,
                                      float* __restrict__ dw) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= size) return;
  float s = 0.f;
  for (int c = 0; c < n_chunks; ++c) s += __ldg(partials + c * size + e);
  dw[e] = s;
}

template <int BM, int BN, int TM, int TN>
void launch(const float* feats, int cin, const int32_t* rows, int k_out,
            int ta, const float* g, int cout, int n_chunks, int chunk_rows,
            float* out, cudaStream_t stream) {
  dim3 grid(n_chunks * ta, (cin + BM - 1) / BM, (cout + BN - 1) / BN);
  dim3 block((BM / TM) * (BN / TN));
  conv_dw_kernel<BM, BN, TM, TN><<<grid, block, 0, stream>>>(
      feats, cin, rows, k_out, ta, g, cout, chunk_rows, out);
}

// tile: the (Cin, Cout) tile edge, 16, 32 or 64 (the wrapper's choice);
// partials: [n_chunks, Ta, Cin, Cout] scratch, unused when n_chunks is 1.
int conv_dw(const void* feats, int cin, const void* rows, int k_out, int ta,
            const void* g, int cout, int tile, int n_chunks, int chunk_rows,
            void* partials, void* dw, void* stream) {
  if (n_chunks < 1 || chunk_rows < 1 ||
      (int64_t)n_chunks * chunk_rows < k_out ||
      (n_chunks > 1 && partials == nullptr))
    return (int)cudaErrorInvalidValue;
  int64_t size = (int64_t)ta * cin * cout;
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
  switch (tile) {
    case 16:
      launch<16, 16, 1, 1>(f, cin, rw, k_out, ta, gg, cout, n_chunks,
                           chunk_rows, out, s);
      break;
    case 32:
      launch<32, 32, 2, 2>(f, cin, rw, k_out, ta, gg, cout, n_chunks,
                           chunk_rows, out, s);
      break;
    case 64:
      launch<64, 64, 4, 4>(f, cin, rw, k_out, ta, gg, cout, n_chunks,
                           chunk_rows, out, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  int err = (int)cudaGetLastError();
  if (err != 0 || n_chunks == 1) return err;
  const int threads = 256;
  int64_t blocks = (size + threads - 1) / threads;
  conv_dw_reduce_kernel<<<(unsigned)blocks, threads, 0, s>>>(
      (const float*)partials, n_chunks, size, (float*)dw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int msmd_conv_dw(const void* feats, int cin, const void* rows,
                            int k_out, int ta, const void* g, int cout,
                            int tile, int n_chunks, int chunk_rows,
                            void* partials, void* dw, void* stream) {
  return conv_dw(feats, cin, rows, k_out, ta, g, cout, tile, n_chunks,
                 chunk_rows, partials, dw, stream);
}
