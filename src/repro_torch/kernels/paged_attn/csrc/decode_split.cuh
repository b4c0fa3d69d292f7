// Split-KV decode walk shared by the two decode kernels (paged_decode.cu
// and ../../decode_attn/csrc/decode_attn.cu), for sm_90a.
//
// One new query token per slot: the G query heads of one KV head against
// the slot's first n_keys keys, float32 online softmax, a slot with no key
// giving zeros (acc / max(l, 1e-30)).  A call launches `splits` CTAs per
// (slot, KV head, group of at most kCtaRows query rows) as one
// thread-block cluster: grid (splits, B, Hkv x row_groups(G)), cluster
// (splits, 1, 1), so a CTA's rank in its cluster is blockIdx.x.
// Rank r walks the keys rank_range(r, splits, n_keys), the formula of
// split.py's split_range: the slot's 16-key tiles shared out evenly, ranks
// in order, and a rank past the slot's last tile walks nothing.  The ranks
// then merge their states through distributed shared memory: one launch,
// no global scratch, no atomics.
//
// Within a CTA of four warps, each warp walks its own keys, a warp-step at
// a time.  A key row is kChunks 16-byte chunks, one per lane, so a
// warp-step covers 32 / kChunks keys, and kUnroll warp-steps of K and V
// are loaded into registers before any of them is used.  Each lane holds
// its chunk of q for each of the CTA's rows (pre-scaled by log2(e) /
// sqrt(D), so the softmax runs on exp2) and its own (m, l, acc) per row; a
// key's score is summed over its lanes by shuffles.  A lane's instructions
// per key grow with its rows, and at serving batch sizes a CTA runs alone
// on its SM, one warp per scheduler, so that chain of dependent
// instructions, not the bytes, sets the time: hence at most kCtaRows rows
// a CTA, and more CTAs reading the same keys.  A key past the range never
// loads and adds nothing: its weight is set to 0 by position, not by
// score, so a rank with no key keeps (-1e30, 0, 0) and adds nothing at the
// merge (exp2(-1e30 - M) = 0), and a rank never counts a masked key into
// l.  Paged keys read their page ids from shared memory, staged for the
// rank's range (kStagePages at a time), so the loop has no dependent
// table load.  At the end the
// lanes of a warp merge by shuffles, the warps of a CTA through shared
// memory, and the ranks of a cluster through distributed shared memory,
// each rank finishing its share of the CTA's rows x D outputs; a second
// cluster barrier keeps every CTA's shared memory alive until its peers
// have read it.
#pragma once

#include <cooperative_groups.h>

#include <climits>

#include "paged_attn_common.cuh"

namespace paged_attn {
namespace split {

namespace cg = cooperative_groups;

constexpr int kWarps = 4;
constexpr int kBlock = kWarps * 32;   // threads a CTA
constexpr int kTile = 16;          // keys: TILE in split.py
constexpr int kMaxSplits = 8;      // MAX_SPLITS in split.py
constexpr int kStagePages = 256;   // page ids staged in shared memory at once
constexpr int kMaxGroup = 16;      // query heads per KV head: DECODE_MAX_GROUP
constexpr int kCtaRows = 2;        // query rows a CTA keeps by default:
                                   // CTA_ROWS (the dense kernel's always)
constexpr float kLog2e = 1.4426950408889634f;

// Keys [lo, hi) of rank `rank` of `splits` over a slot of n_keys keys.
__device__ __forceinline__ int2 rank_range(int rank, int splits,
                                           int n_keys) {
  const int tiles = (n_keys + kTile - 1) / kTile;
  const int per = (tiles + splits - 1) / splits * kTile;
  const int lo = min(rank * per, n_keys);
  return make_int2(lo, min(lo + per, n_keys));
}

// A key row of D elements of T as 16-byte chunks, one per lane.
template <typename T, int D>
struct RowLanes {
  static constexpr int kVec = 16 / sizeof(T);   // elements per lane
  static constexpr int kChunks = D / kVec;      // lanes per key
  static constexpr int kKeys = 32 / kChunks;    // keys per warp-step
  static_assert(D % kVec == 0 && 32 % kChunks == 0,
                "a row's 16-byte chunks must tile a warp");
};

// Key sources: the row index, in rows of D elements, of key kp.
// Paged: the page ids of a run of keys are staged in shared memory, and
// PagedRows (which clamps each id below n_pages) reads them there.
struct StagedPages {
  static constexpr bool kStaged = true;
  PagedRows table;   // over the slot's row of the global table
  int* ids;          // shared memory, kStagePages entries
  int first;         // logical page of ids[0]
  __device__ __forceinline__ int max_keys() const {
    return (kStagePages - 1) * table.page_size;
  }
  __device__ __forceinline__ void stage(int c0, int c1) {
    first = c0 / table.page_size;
    const int n = (c1 - 1) / table.page_size - first + 1;
    for (int i = threadIdx.x; i < n; i += kBlock)
      ids[i] = table.table_row[first + i];
  }
  __device__ __forceinline__ int64_t operator()(int kp) const {
    return PagedRows{ids, table.n_pages, table.page_size, table.hkv,
                     table.head}(kp - first * table.page_size);
  }
};

// Dense stripes: a fixed stride, nothing to stage.
struct Stripe {
  static constexpr bool kStaged = false;
  StripeRows rows;
  __device__ __forceinline__ int max_keys() const { return INT_MAX; }
  __device__ __forceinline__ void stage(int, int) {}
  __device__ __forceinline__ int64_t operator()(int kp) const {
    return rows(kp);
  }
};

// Query rows a CTA keeps in registers (the walk's GMAX): G rounded up to a
// power of two, at most cta_rows, itself a power of two (rows past G hold
// q = 0 and are never written).  A larger G is split over
// row_groups(G, cta_rows) CTAs of a (slot, KV head) and rank, which read
// the same keys (L2 can serve all reads but the first).  The kernels
// compute their row group from GMAX, which gives the same count: GMAX is
// cta_rows when G >= cta_rows, and one group holds all of G otherwise.
inline int group_rows(int g, int cta_rows) {
  int r = 1;
  while (r < g && r < cta_rows) r <<= 1;
  return r;
}
inline int row_groups(int g, int cta_rows) {
  return (g + cta_rows - 1) / cta_rows;
}

// Shared-memory bytes: the staged page ids, then the four warps' states
// and the CTA's merged state (acc [GMAX][D], m [GMAX], l [GMAX] each).
template <int D, int GMAX, bool kStaged>
constexpr int smem_bytes() {
  return (kStaged ? 4 * kStagePages : 0) + 4 * (kWarps + 1) * GMAX * (D + 2);
}

// The walk of one CTA: rank blockIdx.x of the cluster of (slot, KV head)
// whose G query rows start at element row0 of q and out.
template <typename T, int D, int GMAX, typename Keys>
__device__ __forceinline__ void decode_walk(
    const T* __restrict__ q, T* __restrict__ out,
    const T* __restrict__ k_rows, const T* __restrict__ v_rows, Keys keys,
    int64_t row0, int g, int n_keys, float qscale, unsigned char* smem) {
  using L = RowLanes<T, D>;
  constexpr int kVec = L::kVec, kChunks = L::kChunks, kKeys = L::kKeys;
  constexpr int kUnroll = 4;
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunk = lane % kChunks, sub = lane / kChunks;
  const int splits = gridDim.x, rank = blockIdx.x;

  // q in 16-byte loads (the wrappers require a 16-byte aligned q)
  float qf[GMAX][kVec];
#pragma unroll
  for (int r = 0; r < GMAX; ++r) {
    if (r < g) {
      widen(ldg16(q + row0 + r * D + chunk * kVec), qf[r]);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) qf[r][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) qf[r][i] *= qscale;
  }
  float m[GMAX], l[GMAX], acc[GMAX][kVec];
#pragma unroll
  for (int r = 0; r < GMAX; ++r) {
    m[r] = kMaskValue;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[r][i] = 0.f;
  }

  const int2 range = rank_range(rank, splits, n_keys);
  for (int c0 = range.x; c0 < range.y;) {
    const int c1 = c0 + min(range.y - c0, keys.max_keys());
    if constexpr (Keys::kStaged) {
      keys.stage(c0, c1);
      __syncthreads();
    }
    // warp-step j of this warp covers keys c0 + (j * kWarps + warp) * kKeys
    // + [0, kKeys); the loop's bound is the same for every lane of a warp
    for (int j0 = 0; c0 + (j0 * kWarps + warp) * kKeys < c1; j0 += kUnroll) {
      uint4 kr[kUnroll], vr[kUnroll];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int kp = c0 + ((j0 + u) * kWarps + warp) * kKeys + sub;
        ok[u] = kp < c1;
        kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
        if (ok[u]) {
          const int64_t off = keys(kp) * D + chunk * kVec;
          kr[u] = ldg16(k_rows + off);
          vr[u] = ldg16(v_rows + off);
        }
      }
      float s[kUnroll][GMAX];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float kf[kVec];
        widen(kr[u], kf);
#pragma unroll
        for (int r = 0; r < GMAX; ++r) {
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < kVec; ++i) dot = fmaf(qf[r][i], kf[i], dot);
          s[u][r] = dot;
        }
      }
#pragma unroll
      for (int o = 1; o < kChunks; o <<= 1)
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int r = 0; r < GMAX; ++r)
            s[u][r] += __shfl_xor_sync(kAll, s[u][r], o);
#pragma unroll
      for (int r = 0; r < GMAX; ++r) {
        float mx = m[r];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (ok[u]) mx = fmaxf(mx, s[u][r]);
        const float corr = exp2f(m[r] - mx);
        m[r] = mx;
        l[r] *= corr;
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[r][i] *= corr;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float vf[kVec];
        widen(vr[u], vf);
#pragma unroll
        for (int r = 0; r < GMAX; ++r) {
          const float p = ok[u] ? exp2f(s[u][r] - m[r]) : 0.f;
          l[r] += p;
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc[r][i] = fmaf(p, vf[i], acc[r][i]);
        }
      }
    }
    if constexpr (Keys::kStaged) __syncthreads();   // before a restage
    c0 = c1;
  }

  // the key groups of a warp merge by shuffles
#pragma unroll
  for (int o = kChunks; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < GMAX; ++r) {
      const float mo = __shfl_xor_sync(kAll, m[r], o);
      const float lo = __shfl_xor_sync(kAll, l[r], o);
      const float mx = fmaxf(m[r], mo);
      const float a = exp2f(m[r] - mx), c = exp2f(mo - mx);
      l[r] = l[r] * a + lo * c;
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        acc[r][i] = acc[r][i] * a + __shfl_xor_sync(kAll, acc[r][i], o) * c;
      m[r] = mx;
    }
  }
  float* w_acc = reinterpret_cast<float*>(
      smem + (Keys::kStaged ? 4 * kStagePages : 0));
  float* w_m = w_acc + kWarps * GMAX * D;
  float* w_l = w_m + kWarps * GMAX;
  float* c_acc = w_l + kWarps * GMAX;
  float* c_m = c_acc + GMAX * D;
  float* c_l = c_m + GMAX;
  if (sub == 0) {
#pragma unroll
    for (int r = 0; r < GMAX; ++r) {
      if (r < g) {
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          w_acc[(warp * GMAX + r) * D + chunk * kVec + i] = acc[r][i];
      }
      if (chunk == 0) {
        w_m[warp * GMAX + r] = m[r];
        w_l[warp * GMAX + r] = l[r];
      }
    }
  }
  __syncthreads();

  // the warps of the CTA merge through shared memory
  const int n_out = g * D;
  for (int e = threadIdx.x; e < n_out; e += kBlock) {
    const int r = e / D;
    float mx = kMaskValue;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, w_m[w * GMAX + r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = exp2f(w_m[w * GMAX + r] - mx);
      lsum += w_l[w * GMAX + r] * c;
      a += w_acc[(w * GMAX + r) * D + e % D] * c;
    }
    if (splits == 1) {
      out[row0 + e] = from_f32<T>(a / fmaxf(lsum, 1e-30f));
    } else {
      c_acc[e] = a;
      if (e % D == 0) {
        c_m[r] = mx;
        c_l[r] = lsum;
      }
    }
  }
  if (splits == 1) return;

  // the ranks of the cluster merge through distributed shared memory; each
  // finishes its share of the outputs
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int per = (n_out + splits - 1) / splits;
  const int e_end = min(n_out, (rank + 1) * per);
  for (int e = rank * per + threadIdx.x; e < e_end; e += kBlock) {
    const int r = e / D;
    // every peer's state first, all loads in flight; a rank past `splits`
    // reads as (-1e30, 0, 0)
    float pm[kMaxSplits], pl[kMaxSplits], pa[kMaxSplits];
#pragma unroll
    for (int p = 0; p < kMaxSplits; ++p) {
      pm[p] = kMaskValue;
      pl[p] = pa[p] = 0.f;
      if (p < splits) {
        pm[p] = cluster.map_shared_rank(c_m, p)[r];
        pl[p] = cluster.map_shared_rank(c_l, p)[r];
        pa[p] = cluster.map_shared_rank(c_acc, p)[e];
      }
    }
    float mx = kMaskValue;
#pragma unroll
    for (int p = 0; p < kMaxSplits; ++p) mx = fmaxf(mx, pm[p]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int p = 0; p < kMaxSplits; ++p) {
      const float c = exp2f(pm[p] - mx);
      lsum += pl[p] * c;
      a += pa[p] * c;
    }
    out[row0 + e] = from_f32<T>(a / fmaxf(lsum, 1e-30f));
  }
  cluster.sync();   // no CTA leaves while a peer may still read it
}

// Launch `kernel` on grid (splits, batch, heads) in clusters of `splits`
// CTAs along x, on `stream`; returns the launch status.
template <typename... Params, typename... Args>
inline cudaError_t launch_clusters(void (*kernel)(Params...), int splits,
                                   int batch, int heads, int smem,
                                   cudaStream_t stream, Args... args) {
  if (splits != 1 && splits != 2 && splits != 4 && splits != kMaxSplits)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, batch, heads);
  cfg.blockDim = dim3(kBlock, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace split
}  // namespace paged_attn
