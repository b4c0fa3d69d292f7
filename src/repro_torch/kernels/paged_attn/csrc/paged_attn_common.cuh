// Shared device code of the attention kernels: the conversions, the
// key-row functors (PagedRows, StripeRows) and the shared-memory helper,
// and the tile walk `attend_rows` of the float32 prefill (paged_prefill.cu):
// a flash-attention walk of one (slot, KV head) row block over the slot's
// keys, with the online softmax in float32.  The two decode kernels
// (paged_decode.cu, ../../decode_attn/csrc/decode_attn.cu) run the split-KV
// walk of decode_split.cuh instead, and the bfloat16 prefill
// (paged_prefill_tc.cu) a tensor-core walk of its own.
//
// A CTA owns `rows` query rows (at most RMAX) of one slot and one KV head.
// It walks the slot's keys in tiles of TILE rows.  Each tile asks a key-row
// functor for the address of each of its rows: through the page table
// (the CUDA stand-in for the TPU kernels' scalar-prefetched index maps), or
// at a fixed stride into a contiguous stripe.  It stages K and V in shared
// memory as float32, scores every (row, key) pair, folds the tile into the
// running (m, l, acc) state and moves on.  Keys at or past `n_keys` are never loaded; a key
// above a row's causal position `row_pos[r]` scores -1e30, exactly as the
// JAX kernels mask.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace paged_attn {

constexpr int kThreads = 128;
constexpr float kMaskValue = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One 16-byte load: 4 float32 or 8 bfloat16 values.  The wrappers require
// 16-byte aligned pools, stripes and q; every row starts on a multiple of
// D elements, and D * sizeof(T) is a multiple of 16.
__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// 16 bytes as float32 values: 4 float32, or 8 bfloat16 (a bfloat16 is the
// high half of a float32, the lower-addressed one in the low bits).
__device__ __forceinline__ void widen(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void widen(const uint4& r, float (&f)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared-memory bytes of one CTA.  K and the score rows are padded by one
// float so that a warp reading down a column hits 32 different banks.
template <int D, int TILE, int RMAX>
constexpr int smem_bytes() {
  return TILE * 8                    // key element offsets (int64)
         + RMAX * 8                  // query/output row offsets (int64)
         + RMAX * 4                  // row causal positions (int32)
         + 4 * (RMAX * (D + 1)       // q rows
                + TILE * (D + 1)     // K tile
                + TILE * D           // V tile
                + RMAX * (TILE + 1)  // scores, then probabilities
                + 3 * RMAX);         // m, l, correction
}

struct RowBlock {
  int64_t* row_off;  // [RMAX] element offset of each row in q and out
  int* row_pos;      // [RMAX] absolute position of each row's query
  int rows;          // live rows of this block (<= RMAX)
};

// Carve the dynamic shared memory; the kernels fill row_off/row_pos.
template <int D, int TILE, int RMAX>
__device__ __forceinline__ RowBlock row_block(unsigned char* smem) {
  RowBlock rb;
  rb.row_off = reinterpret_cast<int64_t*>(smem + TILE * 8);
  rb.row_pos = reinterpret_cast<int*>(smem + TILE * 8 + RMAX * 8);
  rb.rows = 0;
  return rb;
}

// Key-row functors: the index, in rows of D elements, of key row `kp` of
// this CTA's slot and KV head.
struct PagedRows {       // pools [n_pages, page_size, hkv, D], one table row
  const int* table_row;
  int n_pages, page_size, hkv, head;
  __device__ __forceinline__ int64_t operator()(int kp) const {
    int page = table_row[kp / page_size];
    page = min(max(page, 0), n_pages - 1);  // never read out of bounds
    return (static_cast<int64_t>(page) * page_size + kp % page_size) * hkv +
           head;
  }
};

struct StripeRows {      // stripes [B, S, hkv, D]: base = b * S * hkv + head
  int64_t base;
  int hkv;
  __device__ __forceinline__ int64_t operator()(int kp) const {
    return base + static_cast<int64_t>(kp) * hkv;
  }
};

template <typename T, int D, int TILE, int RMAX, typename KeyRows>
__device__ void attend_rows(const T* __restrict__ q, T* __restrict__ out,
                            const T* __restrict__ k_rows,
                            const T* __restrict__ v_rows, KeyRows key_row,
                            int n_keys, float scale, const RowBlock& rb,
                            unsigned char* smem) {
  constexpr int NT = kThreads;
  constexpr int OPT = (RMAX * D + NT - 1) / NT;  // outputs per thread
  constexpr int kVec = 16 / sizeof(T);            // elements per 16 bytes
  constexpr int kChunks = D / kVec;               // 16-byte chunks per row
  static_assert(D % kVec == 0, "rows must be whole 16-byte chunks");
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rows = rb.rows;

  int64_t* key_off = reinterpret_cast<int64_t*>(smem);
  float* q_s = reinterpret_cast<float*>(smem + TILE * 8 + RMAX * 12);
  float* k_s = q_s + RMAX * (D + 1);
  float* v_s = k_s + TILE * (D + 1);
  float* s_s = v_s + TILE * D;
  float* m_s = s_s + RMAX * (TILE + 1);
  float* l_s = m_s + RMAX;
  float* c_s = l_s + RMAX;

  for (int e = tid; e < rows * D; e += NT) {
    const int r = e / D, d = e % D;
    q_s[r * (D + 1) + d] = to_f32(q[rb.row_off[r] + d]);
  }
  for (int r = tid; r < RMAX; r += NT) {
    m_s[r] = kMaskValue;
    l_s[r] = 0.f;
  }
  float acc[OPT];
#pragma unroll
  for (int i = 0; i < OPT; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < n_keys; t0 += TILE) {
    // 1. element offset of each key row of the tile (-1: past the walk)
    for (int j = tid; j < TILE; j += NT) {
      const int kp = t0 + j;
      key_off[j] = kp < n_keys ? key_row(kp) * D : -1;
    }
    __syncthreads();
    // 2. stage K and V: 16-byte loads, neighbouring threads on
    //    neighbouring chunks of a row (all of a thread's loads in flight)
#pragma unroll
    for (int it = 0; it < (TILE * kChunks + NT - 1) / NT; ++it) {
      const int e = tid + it * NT;
      if (e >= TILE * kChunks) break;
      const int j = e / kChunks, c = e % kChunks;
      const int64_t off = key_off[j];
      float kf[kVec], vf[kVec];
      if (off >= 0) {
        widen(ldg16(k_rows + off + c * kVec), kf);
        widen(ldg16(v_rows + off + c * kVec), vf);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) kf[i] = vf[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        k_s[j * (D + 1) + c * kVec + i] = kf[i];
        v_s[j * D + c * kVec + i] = vf[i];
      }
    }
    __syncthreads();
    // 3. scores, masked past the walk and above each row's causal position
    for (int e = tid; e < rows * TILE; e += NT) {
      const int r = e / TILE, j = e % TILE;
      const int kp = t0 + j;
      float s = kMaskValue;
      if (kp < n_keys && kp <= rb.row_pos[r]) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d)
          dot = fmaf(q_s[r * (D + 1) + d], k_s[j * (D + 1) + d], dot);
        s = dot * scale;
      }
      s_s[r * (TILE + 1) + j] = s;
    }
    __syncthreads();
    // 4. online softmax, one warp per row
    for (int r = warp; r < rows; r += NT / 32) {
      float* srow = s_s + r * (TILE + 1);
      float mx = kMaskValue;
      for (int j = lane; j < TILE; j += 32) mx = fmaxf(mx, srow[j]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < TILE; j += 32) {
        const float p = expf(srow[j] - m_new);
        srow[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        l_s[r] = l_s[r] * c + sum;
        c_s[r] = c;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // 5. acc = acc * correction + P @ V
#pragma unroll
    for (int i = 0; i < OPT; ++i) {
      const int idx = tid + i * NT;
      const int r = idx / D, d = idx % D;
      if (r < rows) {
        const float* prow = s_s + r * (TILE + 1);
        float a = acc[i] * c_s[r];
#pragma unroll 8
        for (int j = 0; j < TILE; ++j) a = fmaf(prow[j], v_s[j * D + d], a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < OPT; ++i) {
    const int idx = tid + i * NT;
    const int r = idx / D, d = idx % D;
    if (r < rows)
      out[rb.row_off[r] + d] = from_f32<T>(acc[i] / fmaxf(l_s[r], 1e-30f));
  }
}

// Raise the dynamic shared-memory limit of `kernel` when it needs more
// than the default 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// dtype codes shared with the binding
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

}  // namespace paged_attn
