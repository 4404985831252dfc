// One-hot sparse convolution: the queries of a plan are matched against
// the input keys inside the conv, fp32, with the inference epilogue (BN
// affine, ReLU, valid mask) fused in. No rulebook is stored.
//
// Replaces the TPU kernel msmdfusion_tpu/ops/sparse/matchconv.py
// _match_kernel (wrapper _pallas_conv). That kernel DMA'd a slab of the
// sorted input keys and transposed features into VMEM per tile and tap
// group, built the one-hot match matrix (query == key) for a chunk of the
// slab and contracted it with the features on the MXU (features as an
// exact bf16 hi/lo pair), then applied the weights. Here a block owns BM
// output rows and BN output channels:
//
//   out[r] = epi( sum_t feats[match(r, t)] @ W[t] )
//   match(r, t) = the row i with in_keys[i] == query(r, t), where inb[r, t]
//                 holds and the query is a real key, else a miss (adds 0)
//   query(r, t) = okeys[r] + dkey[t] (affine plan, summed in 64 bits: an
//                 INT_MAX row never wraps into a real key) or queries[r, t]
//   epi(v) = valid[r] ? relu?(v * scale + shift) : 0
//
// The block first runs the binary searches of all its BM x Ta (row, tap)
// pairs together (key_search.cuh; the taps of one row on neighbouring
// threads, so their searches share their first steps in cache) into
// shared memory, then walks the taps exactly as gather_gemm_conv.cu does:
// stage the BM matched rows (zero on a miss) and the [Cin, BN] weight
// slice in BK-deep chunks, FFMA a TM x TN tile per thread in fp32, skip a
// tap that no row of the block hits. No bf16 anywhere: the TPU kernel's
// hi/lo split and 3-pass products were MXU devices, not the contract.
//
// Bound on the card: the operations and bytes of gather_gemm_conv.cu
// (2 * hits * Cin * Cout fp32 FLOP) plus the plan it reads (inb and the
// queries or okeys) and the keys it searches (~log2(K_in) dependent loads
// per pair from L2). Each column tile of BN channels repeats the searches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "key_search.cuh"

namespace {

constexpr int BK = 32;
constexpr int MAX_TAPS = 27;

struct PlanQueries {
  const int32_t* keys;
  int k_in;
  const int32_t* okeys;    // affine form, or nullptr
  const int32_t* dkey;
  const int32_t* queries;  // explicit form, or nullptr
  const uint8_t* inb;
  int ta;

  // the matched input row of (r, t), or -1
  __device__ __forceinline__ int32_t row(int r, int t) const {
    int64_t idx = (int64_t)r * ta + t;
    if (!__ldg(inb + idx)) return -1;
    int64_t q;
    if (queries != nullptr) {
      q = __ldg(queries + idx);
    } else {
      int32_t okey = __ldg(okeys + r);
      if (okey == INT_MAX_KEY) return -1;
      q = (int64_t)okey + __ldg(dkey + t);
    }
    if (q < 0 || q >= INT_MAX_KEY) return -1;
    return find_key(keys, k_in, (int32_t)q);
  }
};

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
match_conv_kernel(const float* __restrict__ feats, int cin, PlanQueries plan,
                  int k_out, const float* __restrict__ weights, int cout,
                  const float* __restrict__ scale,
                  const float* __restrict__ shift, int relu,
                  const uint8_t* __restrict__ out_valid,
                  float* __restrict__ out) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int TX = BN / TN;
  __shared__ int s_rows[MAX_TAPS * BM];   // [tap][row]
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int r0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ta = plan.ta;

  for (int e = tid; e < BM * ta; e += NT) {
    int m = e / ta;
    int t = e - m * ta;
    int r = r0 + m;
    s_rows[t * BM + m] = (r < k_out) ? plan.row(r, t) : -1;
  }
  __syncthreads();

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < ta; ++t) {
    const int* rows_t = s_rows + t * BM;
    if (!__syncthreads_or(tid < BM && rows_t[tid] >= 0)) continue;
    const float* w_t = weights + (int64_t)t * cin * cout;
    for (int k0 = 0; k0 < cin; k0 += BK) {
      const int kmax = min(BK, cin - k0);
      for (int e = tid; e < BM * BK; e += NT) {
        int m = e / BK;
        int k = e - m * BK;
        int row = rows_t[m];
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
void launch(const float* feats, int cin, const PlanQueries& plan, int k_out,
            const float* weights, int cout, const float* scale,
            const float* shift, int relu, const uint8_t* out_valid,
            float* out, cudaStream_t stream) {
  dim3 grid((k_out + BM - 1) / BM, (cout + BN - 1) / BN);
  dim3 block((BM / TM) * (BN / TN));
  match_conv_kernel<BM, BN, TM, TN><<<grid, block, 0, stream>>>(
      feats, cin, plan, k_out, weights, cout, scale, shift, relu, out_valid,
      out);
}

}  // namespace

// okeys and dkey (affine plan) or queries (explicit plan) may be null;
// queries win when both are given. At most MAX_TAPS taps.
extern "C" int msmd_match_conv(const void* feats, int cin,
                               const void* in_keys, int k_in,
                               const void* okeys, const void* dkey,
                               const void* queries, const void* inb,
                               int k_out, int ta, const void* weights,
                               int cout, const void* scale,
                               const void* shift, int relu,
                               const void* out_valid, void* out,
                               void* stream) {
  if (ta < 1 || ta > MAX_TAPS ||
      (queries == nullptr && (okeys == nullptr || dkey == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (k_out > 0 && cout > 0) {
    PlanQueries plan{(const int32_t*)in_keys, k_in, (const int32_t*)okeys,
                     (const int32_t*)dkey, (const int32_t*)queries,
                     (const uint8_t*)inb, ta};
    auto f = (const float*)feats;
    auto w = (const float*)weights;
    auto sc = (const float*)scale;
    auto sh = (const float*)shift;
    auto ov = (const uint8_t*)out_valid;
    auto o = (float*)out;
    auto s = (cudaStream_t)stream;
    if (cout <= 16) {
      launch<64, 16, 4, 1>(f, cin, plan, k_out, w, cout, sc, sh, relu, ov, o,
                           s);
    } else if (cout <= 32) {
      launch<64, 32, 4, 2>(f, cin, plan, k_out, w, cout, sc, sh, relu, ov, o,
                           s);
    } else {
      launch<64, 64, 4, 4>(f, cin, plan, k_out, w, cout, sc, sh, relu, ov, o,
                           s);
    }
  }
  return (int)cudaGetLastError();
}
