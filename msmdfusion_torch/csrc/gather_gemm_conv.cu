// Gather-GEMM sparse convolution over precomputed rulebook rows, exact fp32
// (FFMA), with the inference epilogue (BN affine, ReLU, valid mask) fused
// in: the fp32 rulebook engine's product under MSMD_CONV_GEMM=highest.
//
// Replaces the TPU kernel msmdfusion_tpu/ops/sparse/matchconv.py
// _vgather_kernel (wrapper _vgather_conv), fp32 mode with gemm='highest'.
// That kernel DMA'd a slab of transposed input features into VMEM per tile
// and tap group, gathered the matched columns with lane butterflies and
// applied the weights as a HIGHEST MXU product. Here:
//
//   out[r] = epi( sum_t feats[rows[r, t]] @ W[t] ),  rows[r, t] = -1: miss
//   epi(v) = valid[r] ? relu?(v * scale + shift) : 0
//
// The body is ffma_conv.cuh's, shared with match_conv.cu's exact entry
// point: a block reads its 128 rows' rulebook entries once (contiguous),
// compacts each tap's hits, stages them with the tap's weights by cp.async
// in a ring, and each warp multiplies one 16-hit slice of the tap by fp32
// FFMA register tiles over all of Cout up to 128, the taps summed in a
// shared-memory accumulator. No row order comes from the plan (the highest
// route builds none). Bound: see the header; the narrow stages are bound
// by bytes, the wide ones by fp32 operations.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ffma_conv.cuh"

namespace {

struct RulebookRows {
  const int32_t* rows;     // [K_out, Ta]
  int ta;

  __device__ __forceinline__ int32_t row(int r, int t) const {
    return __ldg(rows + (int64_t)r * ta + t);
  }
};

}  // namespace

// tile, tile_n, kc: matchconv.ffma_launch(cin, cout); at most 64 taps
extern "C" int msmd_gather_gemm_conv(const void* feats, int cin,
                                     const void* rows, int k_out, int ta,
                                     const void* weights, int cout, int tile,
                                     int tile_n, int kc, const void* scale,
                                     const void* shift, int relu,
                                     const void* out_valid, void* out,
                                     void* stream) {
  RulebookRows src{(const int32_t*)rows, ta};
  return ffma_conv::conv(feats, cin, src, k_out, weights, cout, tile, tile_n,
                         kc, scale, shift, relu, out_valid, out, stream);
}
