// Rulebook rows of a sparse-conv plan: two entry points over one device
// design, a block per tile of output rows that matches its rows' queries
// inside windows of the sorted input keys staged in shared memory.
//
// msmd_rows_affine replaces the TPU kernel
// msmdfusion_tpu/ops/sparse/matchconv.py _win_rows_kernel (wrapper
// _win_plan_rows), for plans in affine form (query = okeys[r] + dkey[t]):
// subm and downsample plans.
//
// msmd_rows_queries replaces the TPU kernel _rows_kernel (wrapper
// plan_rows), for plans with explicit queries [K, Ta]: the transpose
// ("dual") plans of the strided convs that the training backward runs on.
//
//   rows[r, t] = i  the first i with in_keys[i] == query(r, t), where
//                    inb[r, t] holds and the query is real (okeys[r] !=
//                    INT_MAX and okeys[r] + dkey[t] within int32 for the
//                    affine form, queries[r, t] != INT_MAX for the explicit)
//              = -1 otherwise,
//
// in_keys [K_in] ascending with an INT_MAX tail. Optionally (masks not
// null, Ta <= 62) each row's tap-hit mask, bit t set where rows[r, t] >=
// 0: the key by which the packed bf16 kernels' row order sorts the rows.
//
// Both TPU kernels matched a 128-row output tile against a window of the
// sorted keys held in VMEM. The design here keeps that idea and drops the
// one-hot compares: a tap's queries over a tile of consecutive output rows
// lie in a short run of the input keys (okeys ascend, and lex_floor_key
// keeps each dual tap's queries ascending), so a block
//
//   1. stages its tile (inb bytes, and okeys or the [rows, Ta] queries)
//      in shared memory by 16-byte cp.async copies, and loads one evenly
//      spaced input key per row beside them (the samples);
//   2. takes, per tap, the range of the tile's live queries: for affine
//      plans the least and greatest valid okey plus the tap's dkey (a
//      superset, from one warp reduction), for explicit queries the least
//      and greatest live query (a warp per tap);
//   3. groups the taps (one warp, ballots): a tap whose range overlaps
//      the previous tap's (taps no row queries have none) joins its group
//      (a kernel row's dx taps, and its dy rows once the tile spans more
//      than one x row), so a group's window, the union of its taps'
//      ranges, never holds more keys than their own windows together;
//   4. finds each window [lower_bound(least), upper_bound(greatest)) of
//      in_keys: the samples narrow each bound to 1/rows of the keys in
//      shared memory, then a warp runs a 32-ary search (one load per lane
//      and round), three rounds at the flagship's K_in <= 188,416 against
//      the ~18 dependent loads of a full binary search; a warp per bound
//      (two samples per row, two rounds, measured slower: the
//      samples' scattered loads cost more than the round saves);
//   5. copies the windows into an 8 KB buffer (kWinCap keys) by 16-byte
//      cp.async copies where they fit together; where they do not (a tile
//      that straddles z slices or spans far over a dense slice: up to
//      1.2% of the flagship's windows, up to 131,801 keys; unsorted okeys)
//      it copies every s-th key of each window instead (4-byte cp.async
//      copies, s >= 2 the least that fits), an index of the windows;
//   6. searches: a thread per (row, group), two threads per row, walks the
//      group's taps in order: a binary search of the group's index for the
//      first, then from the previous tap's place (a lower bound: the query
//      did not fall) after three independent probes a key or two on (a
//      row's dx taps lie one key apart); under a sampled index the < s
//      keys between two samples are searched in device memory inside the
//      same kernel (one or two cache lines at the flagship's sizes);
//   7. stores the [rows, Ta] result tile, staged in shared memory,
//      coalesced by 16-byte stores, and each row's mask, ORed in
//      registers from the staged results, once: no memset and no atomics
//      for the masks.
//
// The windows come from each tap's range over the whole tile (a superset
// of its live queries'), not from the first and last row, so the result
// never depends on the queries being monotone; only the window sizes do.
// A tile stages all its windows in one batch of copies rather than a ring
// of 2-3 with a barrier per group: on the flagship's plans a tile's
// windows total a few hundred keys, the copies of one batch are in flight
// together, and the 7 blocks resident on an SM hide one block's waits
// behind the others' work.
//
// Bound on the card: bytes, those the function must move. Reading in_keys
// (K_in x 4), inb (K x Ta), okeys (K x 4) and dkey, or the queries (K x Ta
// x 4), once, and writing the rows (K x Ta x 4) and masks (K x 8) once,
// over 3.35 TB/s. The design reads more than that: the samples, the
// staged windows (which overlap across tiles and groups) and, in a
// sampled tile, a 32-byte sector per live query; chip_smoke.py prints
// those bytes apart (design_bound_ms), from its PyTorch statement of the
// windows (rows_windows). The work is ~4 dependent device-memory round
// trips per block (tile and samples, the two search rounds, the windows)
// and a few shared-memory probes per (row, tap).

#include <cuda_runtime.h>
#include <stdint.h>

#include "key_search.cuh"

namespace {

constexpr int kWinCap = 2048;         // keys of a block's window buffer
constexpr int kSamplesPerRow = 1;     // evenly spaced keys per tile row
constexpr int kThreadsPerRow = 2;     // threads of a block per tile row
constexpr int kStats = 14;            // per-tap and per-group int arrays
constexpr int32_t kIntMin = -2147483647 - 1;
constexpr unsigned kFull = 0xffffffffu;

// flags: which base pointers take 16-byte copies
constexpr int kKeysVec = 1, kInbVec = 2, kTileVec = 4, kRowsVec = 8;

// rows of a tile for Ta taps (fewer where Ta is large, for shared memory;
// halving the tile of a small call to fill the card measured slower: a
// block's fixed cost of round trips, not idle SMs, sets a small call)
__host__ __device__ constexpr int tile_rows(int ta) {
  return ta <= 64 ? 128 : ta <= 128 ? 64 : 32;
}

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// byte offsets of a block's dynamic shared memory, all 16-byte aligned
struct Layout {
  int vals, okeys, inb, samples, stats, bytes;
  __host__ __device__ Layout(int tile, int ta)
      : vals(kWinCap * 4),
        okeys(vals + tile * ta * 4),
        inb(okeys + tile * 4),
        samples(inb + round_up(tile * ta, 16)),
        stats(samples + kSamplesPerRow * tile * 4),
        bytes(stats + round_up(kStats * ta * 4, 16)) {}
};

// 16 bytes (the first `bytes` of them, the rest zero-filled) from global
// to shared memory, asynchronously
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes));
}

// 4 bytes from global to shared memory, asynchronously
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// bytes [0, n) of src into 16-byte aligned shared dst, by the whole
// block: cp.async copies where src is 16-byte aligned (the last one
// zero-fills past n), plain byte loads otherwise
__device__ void stage(void* dst, const void* src, int n, bool vec) {
  const char* s = static_cast<const char*>(src);
  char* d = static_cast<char*>(dst);
  if (vec) {
    for (int c = threadIdx.x * 16; c < n; c += blockDim.x * 16)
      cp_async16(d + c, s + c, min(16, n - c));
  } else {
    for (int c = threadIdx.x; c < n; c += blockDim.x) d[c] = s[c];
  }
}

// the first i in [lo, hi) with keys[i] >= v (> v where upper), else hi: a
// 32-ary search by the whole warp, one load per lane and round
__device__ int warp_bound(const int32_t* __restrict__ keys, int lo, int hi,
                          int32_t v, bool upper) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    int step = (hi - lo + 31) >> 5;
    int p = lo + (lane + 1) * step - 1;
    bool before = false;
    if (p < hi) {
      int32_t k = __ldg(keys + p);
      before = upper ? k <= v : k < v;
    }
    int c = __popc(__ballot_sync(kFull, before));
    int nhi = min(hi, lo + (c + 1) * step - 1);
    lo += c * step;
    hi = nhi;
  }
  int p = lo + lane;
  bool before = false;
  if (p < hi) {
    int32_t k = __ldg(keys + p);
    before = upper ? k <= v : k < v;
  }
  return lo + __popc(__ballot_sync(kFull, before));
}

// position of sample j of s over k_in keys
__device__ __forceinline__ int sample_pos(int j, int s, int k_in) {
  return (int)((int64_t)j * k_in / s);
}

// the bound of v (as warp_bound over [0, k_in)), narrowed first by the s
// samples in shared memory
__device__ int sampled_bound(const int32_t* __restrict__ keys, int k_in,
                             const int32_t* samples, int s, int32_t v,
                             bool upper) {
  const int lane = threadIdx.x & 31;
  int c = 0;
  for (int j0 = 0; j0 < s; j0 += 32) {
    bool before = false;
    if (j0 + lane < s) {
      int32_t k = samples[j0 + lane];
      before = upper ? k <= v : k < v;
    }
    c += __popc(__ballot_sync(kFull, before));
  }
  int lo = c > 0 ? sample_pos(c - 1, s, k_in) + 1 : 0;
  int hi = c < s ? sample_pos(c, s, k_in) : k_in;
  return warp_bound(keys, lo, hi, v, upper);
}

template <bool kShared>
__device__ __forceinline__ int32_t key_at(const int32_t* p, int i) {
  return kShared ? p[i] : __ldg(p + i);
}

// lower bound of q in [from, to) of the keys at p; with gallop, three
// independent probes at from, from + 1 and from + 3 first (a row's next
// dx tap usually lies a key or two on), then a binary search of the rest
template <bool kShared>
__device__ int lower_bound(const int32_t* p, int from, int to, int32_t q,
                           bool gallop) {
  if (gallop && from < to) {
    const int p1 = min(from + 1, to - 1), p2 = min(from + 3, to - 1);
    const int32_t k0 = key_at<kShared>(p, from);
    const int32_t k1 = key_at<kShared>(p, p1);
    const int32_t k2 = key_at<kShared>(p, p2);
    if (k0 >= q) {
      to = from;
    } else if (k1 >= q) {
      from += 1;
      to = p1;
    } else if (k2 >= q) {
      from = p1 + 1;
      to = p2;
    } else {
      from = p2 + 1;
    }
  }
  while (from < to) {
    const int mid = (from + to) >> 1;
    const bool before = key_at<kShared>(p, mid) < q;
    from = before ? mid + 1 : from;
    to = before ? to : mid;
  }
  return from;
}

// tap t's query of tile row r (dk: the tap's key offset, affine plans);
// false where it is not live
template <bool kAffine>
__device__ __forceinline__ bool query(int r, int t, int ta, int nrows,
                                      const int32_t* okey_s, int32_t dk,
                                      const int32_t* vals,
                                      const uint8_t* inb_s, int32_t* q) {
  if (r >= nrows || !inb_s[r * ta + t]) return false;
  if (kAffine) {
    const int32_t okey = okey_s[r];
    const int64_t q64 = (int64_t)okey + dk;
    *q = (int32_t)q64;
    return okey != INT_MAX_KEY && q64 <= INT_MAX_KEY && q64 >= kIntMin;
  }
  *q = vals[r * ta + t];
  return *q != INT_MAX_KEY;
}

template <bool kAffine>
__global__ void __launch_bounds__(256)
    rows_kernel(const int32_t* __restrict__ in_keys, int k_in,
                const int32_t* __restrict__ okeys,
                const int32_t* __restrict__ dkey,
                const int32_t* __restrict__ queries, int k_out, int ta,
                const uint8_t* __restrict__ inb, int32_t* __restrict__ rows,
                unsigned long long* __restrict__ masks, int flags) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int threads = blockDim.x, tile = threads / kThreadsPerRow;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = threads >> 5;
  const Layout lay(tile, ta);
  int32_t* win = reinterpret_cast<int32_t*>(smem);
  int32_t* vals = reinterpret_cast<int32_t*>(smem + lay.vals);
  int32_t* okey_s = reinterpret_cast<int32_t*>(smem + lay.okeys);
  uint8_t* inb_s = smem + lay.inb;
  int32_t* samples = reinterpret_cast<int32_t*>(smem + lay.samples);
  int32_t* tmin = reinterpret_cast<int32_t*>(smem + lay.stats);
  int32_t *tmax = tmin + ta, *tgrp = tmax + ta, *gmin = tgrp + ta,
          *gmax = gmin + ta, *gt0 = gmax + ta, *gt1 = gt0 + ta,
          *glo = gt1 + ta, *ghi = glo + ta, *goff = ghi + ta,
          *gbase = goff + ta, *gfirst = gbase + ta, *gend = gfirst + ta,
          *tdead = gend + ta;
  __shared__ int s_groups, s_stride, s_dead;

  const int64_t r0 = (int64_t)blockIdx.x * tile;
  const int64_t left = k_out - r0;
  const int nrows = left < tile ? (int)left : tile;
  const int n = nrows * ta;

  // 1. the tile and the samples
  stage(inb_s, inb + r0 * ta, n, flags & kInbVec);
  if (kAffine) {
    stage(okey_s, okeys + r0, nrows * 4, flags & kTileVec);
  } else {
    stage(vals, queries + r0 * ta, n * 4, flags & kTileVec);
  }
  const int n_samples = kSamplesPerRow * tile;
  if (k_in > 0) {
    for (int j = tid; j < n_samples; j += threads)
      samples[j] = __ldg(in_keys + sample_pos(j, n_samples, k_in));
  }
  for (int t = tid; t < ta; t += threads) {
    gmin[t] = INT_MAX_KEY;
    gmax[t] = kIntMin;
    gt0[t] = ta;
    gt1[t] = -1;
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. per tap, the range of the tile's live queries. Affine plans: the
  //    tile's least and greatest valid okey plus the tap's dkey, a superset
  //    (every live query is a valid row's, inb is not read), from one warp
  //    reduction; explicit queries: a warp per tap, each lane over
  //    tile / 32 rows
  if (kAffine) {
    if (warp == 0) {
      int32_t least = INT_MAX_KEY, most = kIntMin;
      for (int r = lane; r < nrows; r += 32) {
        const int32_t okey = okey_s[r];
        if (okey != INT_MAX_KEY) {
          least = min(least, okey);
          most = max(most, okey);
        }
      }
      least = __reduce_min_sync(kFull, least);
      most = __reduce_max_sync(kFull, most);
      for (int t = lane; t < ta; t += 32) {
        const int64_t dk = __ldg(dkey + t);
        const int64_t lo = least + dk, hi = most + dk;
        const bool any = least <= most && lo <= INT_MAX_KEY && hi >= kIntMin;
        tmin[t] = !any ? INT_MAX_KEY : lo < kIntMin ? kIntMin : (int32_t)lo;
        tmax[t] = !any ? kIntMin : hi > INT_MAX_KEY ? INT_MAX_KEY : (int32_t)hi;
      }
    }
  } else {
    for (int t = warp; t < ta; t += warps) {
      int32_t least = INT_MAX_KEY, most = kIntMin;
      for (int r = lane; r < nrows; r += 32) {
        int32_t q = 0;
        if (query<false>(r, t, ta, nrows, okey_s, 0, vals, inb_s, &q)) {
          least = min(least, q);
          most = max(most, q);
        }
      }
      least = __reduce_min_sync(kFull, least);
      most = __reduce_max_sync(kFull, most);
      if (lane == 0) {
        tmin[t] = least;
        tmax[t] = most;
      }
    }
  }
  __syncthreads();

  // 3. groups: a live tap whose range overlaps the previous live tap's
  //    joins its group (one warp, 32 taps a round)
  if (warp == 0) {
    int groups = 0;
    bool carry = false;             // a live tap in an earlier round
    int32_t clo = 0, chi = 0;       // the last one's range
    for (int t0 = 0; t0 < ta; t0 += 32) {
      const int t = t0 + lane;
      const int32_t lo = t < ta ? tmin[t] : INT_MAX_KEY;
      const int32_t hi = t < ta ? tmax[t] : kIntMin;
      const bool live = lo <= hi;
      const unsigned alive = __ballot_sync(kFull, live);
      const unsigned below = alive & ((1u << lane) - 1);
      const int src = below ? 31 - __clz(below) : lane;
      int32_t plo = __shfl_sync(kFull, lo, src);
      int32_t phi = __shfl_sync(kFull, hi, src);
      const bool prev = below != 0 || carry;
      if (!below) {
        plo = clo;
        phi = chi;
      }
      const bool starts = live && !(prev && lo <= phi && hi >= plo);
      const unsigned opened = __ballot_sync(kFull, starts);
      const int g = groups + __popc(opened & ((2u << lane) - 1)) - 1;
      if (t < ta) tgrp[t] = live ? g : -1;
      if (live) {
        atomicMin(gmin + g, lo);
        atomicMax(gmax + g, hi);
        atomicMin(gt0 + g, t);
        atomicMax(gt1 + g, t);
      }
      groups += __popc(opened);
      if (alive) {
        const int last = 31 - __clz(alive);
        clo = __shfl_sync(kFull, lo, last);
        chi = __shfl_sync(kFull, hi, last);
        carry = true;
      }
    }
    if (lane == 0) s_groups = groups;
    // the taps no row of the tile queries
    int dead = 0;
    for (int t0 = 0; t0 < ta; t0 += 32) {
      const int t = t0 + lane;
      const bool idle = t < ta && tgrp[t] < 0;
      const unsigned none = __ballot_sync(kFull, idle);
      if (idle) tdead[dead + __popc(none & ((1u << lane) - 1))] = t;
      dead += __popc(none);
    }
    if (lane == 0) s_dead = dead;
  }
  __syncthreads();
  const int groups = s_groups;

  // 4. each group's window [lower_bound(least), upper_bound(greatest))
  for (int j = warp; j < 2 * groups; j += warps) {
    const int g = j >> 1;
    const bool upper = j & 1;
    const int b = k_in > 0 ? sampled_bound(in_keys, k_in, samples,
                                           n_samples,
                                           upper ? gmax[g] : gmin[g], upper)
                           : 0;
    if (lane == 0) (upper ? ghi : glo)[g] = b;
  }
  __syncthreads();

  // 5. the windows' index into the buffer: every key of every window
  //    where they fit together (from starts rounded down to 16 bytes),
  //    else every s-th key, s common to the tile
  if (tid == 0) {
    const bool vec = flags & kKeysVec;
    int64_t exact = 0, span = 0;
    for (int g = 0; g < groups; ++g) {
      if (ghi[g] <= glo[g]) continue;
      exact += round_up(ghi[g] - (vec ? glo[g] & ~3 : glo[g]), 4);
      span += ghi[g] - glo[g];
    }
    // every s-th key of each window fits: sum ceil(w / s) <= span / s +
    // groups <= kWinCap (and s >= 2 wherever the exact copy, rounded to
    // 16 bytes, does not)
    const int room = max(1, kWinCap - groups);
    const int stride =
        exact <= kWinCap ? 1 : max(2, (int)((span + room - 1) / room));
    int used = 0;
    for (int g = 0; g < groups; ++g) {
      const int lo = glo[g], hi = max(ghi[g], lo);
      const int base = (stride == 1 && vec) ? lo & ~3 : lo;
      goff[g] = used;
      gbase[g] = base;
      gfirst[g] = lo - base;
      gend[g] = stride == 1 ? hi - base : (hi - lo + stride - 1) / stride;
      if (hi > lo) used += stride == 1 ? round_up(hi - base, 4) : gend[g];
    }
    s_stride = stride;
  }
  __syncthreads();
  const int stride = s_stride;
  for (int g = 0; g < groups; ++g) {
    if (ghi[g] <= glo[g]) continue;
    if (stride == 1) {
      stage(win + goff[g], in_keys + gbase[g], (ghi[g] - gbase[g]) * 4,
            flags & kKeysVec);
    } else {
      for (int i = tid; i < gend[g]; i += threads)
        cp_async4(win + goff[g] + i,
                  in_keys + gbase[g] + (int64_t)i * stride);
    }
  }
  // the taps no row queries
  const int dead = s_dead;
  if (dead > 0) {
    for (int i = tid; i < nrows * dead; i += threads) {
      const int r = i / dead;
      vals[r * ta + tdead[i - r * dead]] = -1;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 6. a (row, group) per thread and round: the group's taps in order,
  //    each searched in the index from the previous tap's place, then
  //    (sampled windows) among the < s keys between two samples in device
  //    memory
  for (int item = tid; item < tile * groups; item += threads) {
    const int r = item % tile, g = item / tile;
    if (r >= nrows) continue;
    const int lo = glo[g], hi = ghi[g], base = gbase[g];
    const int32_t* index = win + goff[g];
    int prev_j = gfirst[g];
    int32_t prev_q = kIntMin;
    for (int t = gt0[g]; t <= gt1[g]; ++t) {
      if (tgrp[t] != g) continue;
      int32_t q = 0, res = -1;
      if (hi > lo &&
          query<kAffine>(r, t, ta, nrows, okey_s,
                         kAffine ? __ldg(dkey + t) : 0, vals, inb_s, &q)) {
        const bool after = q >= prev_q;
        const int j = lower_bound<true>(index, after ? prev_j : gfirst[g],
                                        after ? gend[g] : prev_j, q,
                                        after && prev_q != kIntMin);
        int pos;
        int32_t key = 0;
        if (stride == 1) {
          pos = base + j;
          if (pos < hi) key = index[j];
        } else {
          pos = j == 0 ? lo
                       : lower_bound<false>(in_keys,
                                            base + (j - 1) * stride + 1,
                                            min(hi, base + j * stride), q,
                                            false);
          if (pos < hi) key = __ldg(in_keys + pos);
        }
        if (pos < hi && key == q) res = pos;
        prev_q = q;
        prev_j = j;
      }
      vals[r * ta + t] = res;
    }
  }
  __syncthreads();

  // 7. the result tile and the masks, coalesced
  int32_t* out = rows + r0 * ta;
  int done = 0;
  if (flags & kRowsVec) {
    const int n4 = n >> 2;
    for (int i = tid; i < n4; i += threads)
      reinterpret_cast<int4*>(out)[i] = reinterpret_cast<const int4*>(vals)[i];
    done = n4 << 2;
  }
  for (int i = done + tid; i < n; i += threads) out[i] = vals[i];
  // each row's tap-hit mask, ORed in registers from its staged results
  // (both threads of the row wrote them) and written once
  if (masks != nullptr) {
    for (int r = tid; r < nrows; r += threads) {
      unsigned long long mask = 0;
      for (int t = 0; t < ta; ++t)
        mask |= (unsigned long long)(vals[r * ta + t] >= 0) << t;
      masks[r0 + r] = mask;
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool kAffine>
int launch(const int32_t* in_keys, int k_in, const int32_t* okeys,
           const int32_t* dkey, const int32_t* queries, int k_out, int ta,
           const uint8_t* inb, int32_t* rows, unsigned long long* masks,
           cudaStream_t stream) {
  if (k_out > 0 && ta >= 0) {
    const int tile = tile_rows(ta);
    const Layout lay(tile, ta);
    if (lay.bytes > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          rows_kernel<kAffine>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          lay.bytes);
      if (e != cudaSuccess) return (int)e;
    }
    const int flags = (aligned16(in_keys) ? kKeysVec : 0) |
                      (aligned16(inb) ? kInbVec : 0) |
                      (aligned16(kAffine ? okeys : queries) ? kTileVec : 0) |
                      (aligned16(rows) ? kRowsVec : 0);
    const unsigned blocks = (unsigned)((k_out + tile - 1) / tile);
    rows_kernel<kAffine><<<blocks, tile * kThreadsPerRow, lay.bytes,
                           stream>>>(in_keys, k_in, okeys, dkey, queries,
                                     k_out, ta, inb, rows, masks, flags);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int msmd_rows_affine(const void* in_keys, int k_in,
                                const void* okeys, int k_out,
                                const void* dkey, int ta, const void* inb,
                                void* rows, void* masks, void* stream) {
  return launch<true>(
      (const int32_t*)in_keys, k_in, (const int32_t*)okeys,
      (const int32_t*)dkey, nullptr, k_out, ta, (const uint8_t*)inb,
      (int32_t*)rows, (unsigned long long*)masks, (cudaStream_t)stream);
}

extern "C" int msmd_rows_queries(const void* in_keys, int k_in,
                                 const void* queries, int k_rows, int ta,
                                 const void* inb, void* rows, void* masks,
                                 void* stream) {
  return launch<false>(
      (const int32_t*)in_keys, k_in, nullptr, nullptr,
      (const int32_t*)queries, k_rows, ta, (const uint8_t*)inb,
      (int32_t*)rows, (unsigned long long*)masks, (cudaStream_t)stream);
}
