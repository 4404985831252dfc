// One-hot sparse convolution: the queries of a plan are matched against
// the input keys inside the conv, with the inference epilogue (BN affine,
// ReLU, valid mask) fused in. No rulebook is stored.
//
// Replaces the TPU kernel msmdfusion_tpu/ops/sparse/matchconv.py
// _match_kernel (wrapper _pallas_conv). That kernel DMA'd a slab of the
// sorted input keys and transposed features into VMEM per tile and tap
// group, built the one-hot match matrix (query == key) for a chunk of the
// slab and contracted it with the features on the MXU, then applied the
// weights (a HIGHEST GEMM, or hi.hi + hi.lo + lo.hi of bf16 splits where
// that did not fit VMEM). Its features came as an exact bf16 hi/lo pair
// (fp32 input, parts=2) or as themselves (bf16 input, parts=1). The
// function all entry points here compute:
//
//   out[r] = epi( sum_t feats[match(r, t)] @ W[t] )
//   match(r, t) = the row i with in_keys[i] == query(r, t), where inb[r, t]
//                 holds and the query is a real key, else a miss (adds 0)
//   query(r, t) = okeys[r] + dkey[t] (affine plan, summed in 64 bits: an
//                 INT_MAX row never wraps into a real key) or queries[r, t]
//   epi(v) = valid[r] ? relu?(v * scale + shift) : 0     (in fp32)
//
// Three entry points, by the product they take:
//
// - msmd_match_conv (fp32 in and out, the exact product, FFMA; reached
//   under MSMD_CONV_GEMM=highest): ffma_conv.cuh's body, shared with
//   gather_gemm_conv.cu, its rows found by search. A block of 128 output
//   rows runs the binary searches of all its 128 x Ta (row, tap) pairs
//   together, once (key_search.cuh; the taps of one row on neighbouring
//   threads, so their searches share their first steps in cache), into
//   shared memory; it holds all of Cout up to 128 (192 is two column
//   blocks of 96, the only case where the searches repeat), compacts each
//   tap's hits and multiplies them alone, a 16-hit slice a warp, by fp32
//   FFMA register tiles over a cp.async ring. Bound: 2 * hits * Cin * Cout
//   FLOP at the fp32 rate, against the bytes below.
//
// - msmd_match_conv_x3 (fp32 in and out; the default route, replacing
//   parts=2): the x3 product of gather_gemm_conv_bf16.cu's PASSES = 3,
//
//     sum_t hi(f) @ hi(W[t]) + hi(f) @ lo(W[t]) + lo(f) @ hi(W[t])
//     hi(x) = bf16_rn(x), lo(x) = bf16_rn(x - float(hi(x)))
//
//   about 2^-17 of each sum's magnitude from the exact product, the same
//   class as the TPU kernel's hi/lo gather (2^-16) under either of its
//   weight products.
//
// - msmd_match_conv_bf16 (bf16 in and out, replacing parts=1): the bf16
//   features as they are, against the weights' hi and lo,
//
//     out[r] = bf16_rn( epi( sum_t f @ hi(W[t]) + f @ lo(W[t]) ) )
//
//   (for bf16 f the TPU kernel's lo(f) is 0, so its 3-pass product is
//   these two passes; its HIGHEST one lies within 2^-17 of them).
//
// The two tensor-core entry points share one kernel, templated on the
// feature type. Its design is the x3 rulebook kernel's (cp.async ring of
// gathered rows, mma.sync m16n8k16 bf16, each k-step's products into a
// fresh accumulator added to the sum by one fp32 add, a block owning all of
// Cout padded to the next of 16/32/64/80/96/128/192; the wrapper splits
// the weights once per call); the row source is the search:
// - Searches once per row: the block of BM = 128 output rows runs its BM x
//   Ta searches once, into shared memory; never per column tile (only a
//   conv wider than 192 channels takes a second column block).
// - No rulebook, so no plan-side row order: the block builds each row's
//   tap-hit mask from its searched rows and sorts its rows by it in shared
//   memory, stably (a row's rank: the rows of a lower mask, and those of
//   its own before it), so that a warp's 16-row slice shares its taps. The
//   block stages only the taps some slice hits, a warp multiplies only the
//   taps its own slice hits, and a miss inside a hitting slice is
//   zero-filled by cp.async without being read. Each result row is
//   written to its original position; each row's sum runs over its taps
//   in ascending order, whatever the order. (Measured on the H100: the
//   sort lifts the share of staged row-taps that hit from 0.54 to 0.62 on
//   the one-hot frame but takes no time off; plan order gives the same
//   bits.)
// - Gathers: 16-byte cp.async copies where Cin allows (a multiple of 4
//   fp32 or 8 bf16 values, 16-byte aligned rows), else 4-byte ones (fp32)
//   or synchronous 2-byte loads (bf16, e.g. the 5-channel input conv).
//
// Bound on the card: the features (K_in * Cin, 4 or 2 bytes), the keys it
// searches, the plan it reads (inb and the queries or okeys and dkey),
// the fp32 weights and the epilogue's vectors read once, the output (4 or
// 2 bytes) written once; against 2 * hits * Cin * Cout FLOP times the
// passes (3 for x3, 2 for bf16) at the dense bf16 tensor rate. The
// searches add ~log2(K_in) dependent loads per (row, tap) from L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ffma_conv.cuh"
#include "key_search.cuh"
#include "mma_bf16.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// the tensor-core entry points (x3 and bf16 features)
// ---------------------------------------------------------------------------

using namespace mma_bf16;

constexpr int TC_BM = 128;            // output rows per block
constexpr int TC_WARPS = TC_BM / 16;  // one 16-row slice per warp
constexpr int TC_NT = TC_WARPS * 32;  // threads; two per staged row
constexpr int TC_MAX_TAPS = 32;       // a row's tap-hit mask is 32 bits
static_assert(TC_NT == 2 * TC_BM, "two threads stage each row");

template <typename T, int NP, int KC, int NS>
struct TcLayout {
  static constexpr int SA = KC + 8;              // T per staged row
  static constexpr int SB = KC + 8;              // bf16 per weight column
  static constexpr int A_BYTES = TC_BM * SA * (int)sizeof(T);
  static constexpr int B_ELEMS = NP * SB;        // bf16 of one weight chunk
  static constexpr int STAGE = A_BYTES + 2 * B_ELEMS * 2;   // hi, then lo
  static constexpr int BYTES = NS * STAGE;
};

// T float: the x3 product; T __nv_bfloat16: the bf16 features against the
// weights' hi and lo. VEC: bytes of one staging copy (16 or 4 by cp.async;
// 2 by a synchronous load, bf16 rows that 16-byte copies do not fit)
template <typename T, int NP, int KC, int VEC, int NS>
__global__ void __launch_bounds__(TC_NT)
match_conv_tc_kernel(const T* __restrict__ feats, int cin, PlanQueries plan,
                     int k_out, const __nv_bfloat16* __restrict__ wt_hi,
                     const __nv_bfloat16* __restrict__ wt_lo, int n_pad,
                     int kp, int cout, const float* __restrict__ scale,
                     const float* __restrict__ shift, int relu,
                     const uint8_t* __restrict__ out_valid,
                     T* __restrict__ out) {
  constexpr bool X3 = std::is_same<T, float>::value;
  using L = TcLayout<T, NP, KC, NS>;
  constexpr int NN = NP / 8;                      // n8 tiles per warp
  constexpr int PER_COPY = VEC / (int)sizeof(T);  // values per copy
  constexpr int PER_ROW = KC / PER_COPY;          // copies per staged row
  constexpr int B_PER_COL = KC * 2 / 16;          // copies per weight column
  static_assert(PER_COPY >= 1 && KC % PER_COPY == 0, "copy width");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_rows[TC_MAX_TAPS * TC_BM];  // [tap][row in plan order]
  __shared__ uint32_t s_mask[TC_BM];           // tap-hit masks, plan order
  __shared__ int s_pos[TC_BM];                 // sorted position -> row
  __shared__ uint32_t s_slice[TC_WARPS];
  __shared__ int s_taps[TC_MAX_TAPS];
  __shared__ int s_ntaps;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int r0 = blockIdx.x * TC_BM;
  const int n0 = blockIdx.y * NP;
  const int ta = plan.ta;

  // the block's BM x Ta searches, once
  for (int e = tid; e < TC_BM * ta; e += TC_NT) {
    const int m = e / ta;
    const int t = e - m * ta;
    const int r = r0 + m;
    s_rows[t * TC_BM + m] = r < k_out ? plan.row(r, t) : -1;
  }
  __syncthreads();
  if (tid < TC_BM) {
    uint32_t mask = 0;
    for (int t = 0; t < ta; ++t)
      mask |= (uint32_t)(s_rows[t * TC_BM + tid] >= 0) << t;
    s_mask[tid] = mask;
  }
  __syncthreads();
  // each row's rank in the stable sort by mask, counted by its two threads
  // (over the even and the odd rows)
  {
    const int m = tid >> 1;
    const uint32_t mine = s_mask[m];
    int rank = 0;
    for (int j = tid & 1; j < TC_BM; j += 2) {
      const uint32_t other = s_mask[j];
      rank += other < mine || (other == mine && j < m);
    }
    rank += __shfl_xor_sync(0xffffffffu, rank, 1);
    if ((tid & 1) == 0) s_pos[rank] = m;
  }
  __syncthreads();
  // this warp's taps: the OR of its slice's 16 masks; the block's: the OR
  // of its slices'
  uint32_t my_mask = s_mask[s_pos[warp * 16 + (lane & 15)]];
  for (int off = 8; off > 0; off >>= 1)
    my_mask |= __shfl_xor_sync(0xffffffffu, my_mask, off);
  if (lane == 0) s_slice[warp] = my_mask;
  __syncthreads();
  if (warp == 0) {
    uint32_t m = lane < TC_WARPS ? s_slice[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1)
      m |= __shfl_xor_sync(0xffffffffu, m, off);
    if (lane == 0) {
      int n = 0;
      for (; m; m &= m - 1) s_taps[n++] = __ffs((int)m) - 1;
      s_ntaps = n;
    }
  }
  __syncthreads();

  const int nkc = kp / KC;
  const int units = s_ntaps * nkc;     // (tap, Cin chunk), taps ascending
  const int m_stage = tid >> 1;        // the sorted position this pair stages
  const int r_stage = s_pos[m_stage];

  // stage unit u: its gathered rows (zero for a miss and past Cin) and its
  // weight chunks
  auto load = [&](int u, int st) {
    const int t = s_taps[u / nkc];
    const int k0 = (u % nkc) * KC;
    T* as = reinterpret_cast<T*>(smem + st * L::STAGE);
    __nv_bfloat16* bs =
        reinterpret_cast<__nv_bfloat16*>(smem + st * L::STAGE + L::A_BYTES);
    const int row = s_rows[t * TC_BM + r_stage];
    const T* src_row = feats + (int64_t)(row < 0 ? 0 : row) * cin;
#pragma unroll
    for (int j = tid & 1; j < PER_ROW; j += 2) {
      const int col = k0 + j * PER_COPY;
      const bool ok = row >= 0 && col < cin;
      T* dst = as + m_stage * L::SA + j * PER_COPY;
      if constexpr (VEC == 16) {
        cp_async16(dst, ok ? src_row + col : feats, ok);
      } else if constexpr (VEC == 4) {
        cp_async4(dst, ok ? src_row + col : feats, ok);
      } else {
        *reinterpret_cast<unsigned short*>(dst) =
            ok ? __ldg(reinterpret_cast<const unsigned short*>(src_row +
                                                               col))
               : (unsigned short)0;
      }
    }
    const int64_t w0 = ((int64_t)t * n_pad + n0) * kp + k0;
    for (int e = tid; e < NP * B_PER_COL; e += TC_NT) {
      const int n = e / B_PER_COL, j = e - n * B_PER_COL;
      const int64_t src = w0 + (int64_t)n * kp + j * 8;
      cp_async16(bs + n * L::SB + j * 8, wt_hi + src, true);
      cp_async16(bs + L::B_ELEMS + n * L::SB + j * 8, wt_lo + src, true);
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
    if (!((my_mask >> s_taps[u / nkc]) & 1u)) continue;
    const int st = u % NS;
    const T* as = reinterpret_cast<const T*>(smem + st * L::STAGE) +
                  (warp * 16 + g) * L::SA + 2 * c;
    const __nv_bfloat16* bs = reinterpret_cast<const __nv_bfloat16*>(
                                  smem + st * L::STAGE + L::A_BYTES) +
                              g * L::SB + 2 * c;
#pragma unroll
    for (int ks = 0; ks < KC; ks += 16) {
      // A fragment: rows g and g + 8, columns 2c and 2c + 8 (and + 1)
      uint32_t a[4], a_lo[4];
      if constexpr (X3) {
        const float2 v[4] = {
            *reinterpret_cast<const float2*>(as + ks),
            *reinterpret_cast<const float2*>(as + 8 * L::SA + ks),
            *reinterpret_cast<const float2*>(as + ks + 8),
            *reinterpret_cast<const float2*>(as + 8 * L::SA + ks + 8)};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split_bf16(v[i].x, v[i].y, &a[i], &a_lo[i]);
      } else {
        a[0] = *reinterpret_cast<const uint32_t*>(as + ks);
        a[1] = *reinterpret_cast<const uint32_t*>(as + 8 * L::SA + ks);
        a[2] = *reinterpret_cast<const uint32_t*>(as + ks + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(as + 8 * L::SA + ks + 8);
      }
#pragma unroll
      for (int j = 0; j < NN; ++j) {
        const __nv_bfloat16* q = bs + j * 8 * L::SB + ks;
        const __nv_bfloat16* ql = q + L::B_ELEMS;
        uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(q),
                         *reinterpret_cast<const uint32_t*>(q + 8)};
        uint32_t b_lo[2] = {*reinterpret_cast<const uint32_t*>(ql),
                            *reinterpret_cast<const uint32_t*>(ql + 8)};
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma(part, a, b);
        mma(part, a, b_lo);
        if constexpr (X3) mma(part, a_lo, b);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += part[e];
      }
    }
  }

  // epilogue on the fp32 sums; each sorted row to its original position
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + s_pos[warp * 16 + g + 8 * h];
    if (r >= k_out) continue;
    const bool keep = out_valid == nullptr || out_valid[r];
    T* dst = out + (int64_t)r * cout;
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
        v = keep ? v : 0.f;
        if constexpr (X3) {
          dst[n] = v;
        } else {
          dst[n] = __float2bfloat16_rn(v);
        }
      }
  }
}

template <typename T, int NP, int KC, int VEC>
int tc_launch(const T* feats, int cin, const PlanQueries& plan, int k_out,
              const __nv_bfloat16* wt_hi, const __nv_bfloat16* wt_lo,
              int kp, int cout, const float* scale, const float* shift,
              int relu, const uint8_t* out_valid, T* out,
              cudaStream_t stream) {
  constexpr int NS = KC == 16 ? 4 : 3;
  using L = TcLayout<T, NP, KC, NS>;
  auto kernel = match_conv_tc_kernel<T, NP, KC, VEC, NS>;
  // always: the static buffers (~17 KB) count against the 48 KB a block
  // gets without the attribute
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return (int)err;
  const int col_blocks = (cout + NP - 1) / NP;
  dim3 grid((k_out + TC_BM - 1) / TC_BM, col_blocks);
  kernel<<<grid, TC_NT, L::BYTES, stream>>>(
      feats, cin, plan, k_out, wt_hi, wt_lo, col_blocks * NP, kp, cout,
      scale, shift, relu, out_valid, out);
  return (int)cudaGetLastError();
}

// kc 32 with 16-byte copies; otherwise 16-deep chunks, by 16-byte copies
// where they fit, else by the type's narrow copy (kp, a multiple of 32 or
// 16, is a multiple of 16 either way)
template <typename T, int NP>
int tc_dispatch_kc(int kc, bool vec16, const T* feats, int cin,
                   const PlanQueries& plan, int k_out,
                   const __nv_bfloat16* wt_hi, const __nv_bfloat16* wt_lo,
                   int kp, int cout, const float* scale, const float* shift,
                   int relu, const uint8_t* out_valid, T* out,
                   cudaStream_t s) {
  constexpr int NARROW = std::is_same<T, float>::value ? 4 : 2;
  if (kc == 32 && vec16)
    return tc_launch<T, NP, 32, 16>(feats, cin, plan, k_out, wt_hi, wt_lo,
                                    kp, cout, scale, shift, relu, out_valid,
                                    out, s);
  if (vec16)
    return tc_launch<T, NP, 16, 16>(feats, cin, plan, k_out, wt_hi, wt_lo,
                                    kp, cout, scale, shift, relu, out_valid,
                                    out, s);
  return tc_launch<T, NP, 16, NARROW>(feats, cin, plan, k_out, wt_hi, wt_lo,
                                      kp, cout, scale, shift, relu,
                                      out_valid, out, s);
}

template <typename T>
int tc_conv(const void* feats, int cin, const void* in_keys, int k_in,
            const void* okeys, const void* dkey, const void* queries,
            const void* inb, int k_out, int ta, const void* wt_hi,
            const void* wt_lo, int np, int kc, int kp, int cout,
            const void* scale, const void* shift, int relu,
            const void* out_valid, void* out, void* stream) {
  constexpr int NARROW = std::is_same<T, float>::value ? 4 : 2;
  if (ta < 1 || ta > TC_MAX_TAPS ||
      (queries == nullptr && (okeys == nullptr || dkey == nullptr)) ||
      (kc != 16 && kc != 32) || kp % kc != 0 || kp < cin || cin < 1 ||
      wt_hi == nullptr || wt_lo == nullptr ||
      (uintptr_t)feats % NARROW != 0)
    return (int)cudaErrorInvalidValue;
  if (k_out == 0 || cout == 0) return (int)cudaGetLastError();
  const bool vec16 = cin % (16 / (int)sizeof(T)) == 0 &&
                     (uintptr_t)feats % 16 == 0;
  PlanQueries plan{(const int32_t*)in_keys, k_in, (const int32_t*)okeys,
                   (const int32_t*)dkey, (const int32_t*)queries,
                   (const uint8_t*)inb, ta};
  auto f = (const T*)feats;
  auto hi = (const __nv_bfloat16*)wt_hi;
  auto lo = (const __nv_bfloat16*)wt_lo;
  auto sc = (const float*)scale;
  auto sh = (const float*)shift;
  auto ov = (const uint8_t*)out_valid;
  auto o = (T*)out;
  auto s = (cudaStream_t)stream;
#define MSMD_NP(N)                                                          \
  case N:                                                                   \
    return tc_dispatch_kc<T, N>(kc, vec16, f, cin, plan, k_out, hi, lo, kp, \
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

}  // namespace

// okeys and dkey (affine plan) or queries (explicit plan) may be null;
// queries win when both are given. tile, tile_n, kc:
// matchconv.ffma_launch(cin, cout); at most 64 taps.
extern "C" int msmd_match_conv(const void* feats, int cin,
                               const void* in_keys, int k_in,
                               const void* okeys, const void* dkey,
                               const void* queries, const void* inb,
                               int k_out, int ta, const void* weights,
                               int cout, int tile, int tile_n, int kc,
                               const void* scale, const void* shift,
                               int relu, const void* out_valid, void* out,
                               void* stream) {
  // (an empty tensor's pointer may be null)
  if (k_out > 0 && queries == nullptr &&
      (okeys == nullptr || dkey == nullptr))
    return (int)cudaErrorInvalidValue;
  PlanQueries plan{(const int32_t*)in_keys, k_in, (const int32_t*)okeys,
                   (const int32_t*)dkey, (const int32_t*)queries,
                   (const uint8_t*)inb, ta};
  return ffma_conv::conv(feats, cin, plan, k_out, weights, cout, tile,
                         tile_n, kc, scale, shift, relu, out_valid, out,
                         stream);
}

// The x3 route: feats and out fp32 [K_in, Cin] and [K_out, Cout]; wt_hi and
// wt_lo the weights' bf16 hi and lo parts, [Ta][ceil(cout / np) * np][kp]
// zero-padded (the layout of msmd_gather_gemm_conv_x3); np one of
// 16/32/64/80/96/128/192; kc (16 or 32) divides kp and kp >= cin; the plan
// as msmd_match_conv's, at most 32 taps.
extern "C" int msmd_match_conv_x3(
    const void* feats, int cin, const void* in_keys, int k_in,
    const void* okeys, const void* dkey, const void* queries,
    const void* inb, int k_out, int ta, const void* wt_hi,
    const void* wt_lo, int np, int kc, int kp, int cout, const void* scale,
    const void* shift, int relu, const void* out_valid, void* out,
    void* stream) {
  return tc_conv<float>(feats, cin, in_keys, k_in, okeys, dkey, queries, inb,
                        k_out, ta, wt_hi, wt_lo, np, kc, kp, cout, scale,
                        shift, relu, out_valid, out, stream);
}

// bf16 features in, bf16 out (the epilogue in fp32, rounded once to
// nearest even); the rest as msmd_match_conv_x3's.
extern "C" int msmd_match_conv_bf16(
    const void* feats, int cin, const void* in_keys, int k_in,
    const void* okeys, const void* dkey, const void* queries,
    const void* inb, int k_out, int ta, const void* wt_hi,
    const void* wt_lo, int np, int kc, int kp, int cout, const void* scale,
    const void* shift, int relu, const void* out_valid, void* out,
    void* stream) {
  return tc_conv<__nv_bfloat16>(feats, cin, in_keys, k_in, okeys, dkey,
                                queries, inb, k_out, ta, wt_hi, wt_lo, np, kc,
                                kp, cout, scale, shift, relu, out_valid,
                                out, stream);
}
