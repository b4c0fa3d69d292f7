// Paged GQA prefill attention in bfloat16 on the tensor cores, for sm_90a:
// a flash-attention walk over the page table whose two products run as
// mma.sync m16n8k16 (bf16 in, float32 accumulators) from registers.
//
// Replaces, for bfloat16, the TPU kernel
// src/repro/kernels/paged_attn/prefill_kernel.py (`paged_prefill_attn_
// kernel`, body `_make_kernel`).  Same function as paged_prefill.cu's
// float32 walk: row r of a (slot, KV head) is token r / G, group member
// r % G, at position q_offset + r / G; it sees key kpos when kpos <= its
// position and kpos < kv_len; the softmax is float32 online; masked scores
// take kMaskValue, so a row that sees no key in a tile stays finite.
//
// What bounds it on an H100: bytes at a join.  Eight 512-token prompts at
// qwen's D 64, G 7 do 3.8 GFLOP against 17 MB of q, out and K/V (5 us at
// 3.35 TB/s); at moonshot's D 128, G 1, 8.6 GFLOP (8.7 us at the bf16 peak)
// against 67 MB (20 us).  Warp-level tensor-core products do not set the
// pace there; scalar float32 products from shared memory, as in the
// float32 walk, did (10-100x the bound).
//
// What the design does about it.  One CTA per (slot, KV head, block of 64
// fused rows), four warps of 16 rows each; the blocks with the longest
// causal walks start first, so the short ones fill the tail.  The CTA
// stages its q rows in shared memory once (in the second V buffer, before
// the walk's first prefetch needs it), and each warp keeps its Q fragments
// in registers for the whole walk.  K and V tiles of 64 keys are gathered
// row by row through the page table with 16-byte cp.async copies into a
// double-buffered ring (rows padded by 16 bytes, so ldmatrix reads hit 32
// banks); tile t + 1's copies are in flight while tile t is multiplied.
// S = Q K^T and O += P V run on the tensor cores; S, the running (m, l)
// and O stay in registers, and P is rounded to bf16 in registers as the A
// operand of the PV product: no score goes through shared memory, and a
// tile costs two barriers.  The masks are applied to the S fragment by
// position, only on tiles that reach past the block's lowest causal
// position or kv_len.  The walk stops at min(kv_len, causal top of the
// block + 1), as the float32 walk does.
#include "paged_attn_common.cuh"

namespace paged_attn {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = kThreads / 32;   // 4
constexpr int kRows = 16 * kWarps;      // fused rows per CTA
constexpr int kKeys = 64;               // keys per tile
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int LD = D + 8;         // padded row, in elements
  static constexpr int KV = kKeys * LD;    // one K or V tile (or the q rows)
  static constexpr int kBytes = 4 * KV * 2         // 2 x K, 2 x V
                                + kRows * 8        // row offsets
                                + kRows * 4;       // row positions
  static_assert(kRows == kKeys, "the q rows fill one tile buffer");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulators
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 gid + t4.  A (16x16)
// a0 = (gid, 2t4..+1), a1 = (gid + 8, 2t4..), a2 = (gid, 2t4 + 8..),
// a3 = (gid + 8, 2t4 + 8..); B (16x8) b0 = (2t4..+1, gid), b1 = (2t4 + 8..,
// gid); C (16x8) c0, c1 = (gid, 2t4..+1), c2, c3 = (gid + 8, 2t4..+1).
template <int D>
__global__ void __launch_bounds__(kThreads)
prefill_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pages,
                  const bf16* __restrict__ v_pages,
                  const int* __restrict__ table,
                  const int* __restrict__ q_offset,
                  const int* __restrict__ kv_len, bf16* __restrict__ out,
                  int lq, int hq, int hkv, int n_pages, int page_size,
                  int table_width, float scale_log2) {
  using L = Layout<D>;
  constexpr int LD = L::LD;
  constexpr int kChunks = D / 8;        // 16-byte chunks per row
  constexpr int kHalf = kChunks / 2;    // a thread's chunks of a key row
  constexpr int KT = D / 16;            // k-steps of Q K^T
  constexpr int NS = kKeys / 8;         // n-tiles of S
  constexpr int NO = D / 8;             // n-tiles of O
  static_assert(D % 16 == 0 && kThreads == 2 * kKeys, "tile shape");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);   // [2][kKeys][LD]
  bf16* v_s = k_s + 2 * L::KV;                 // [2][kKeys][LD]
  bf16* q_s = v_s + L::KV;    // the q rows, in V's second buffer until the
                              // walk's first prefetch
  int64_t* row_off = reinterpret_cast<int64_t*>(v_s + 2 * L::KV);
  int* row_pos = reinterpret_cast<int*>(row_off + kRows);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, t4 = lane & 3;
  // the grid's slowest index is the row block, from the last (the
  // longest walk) down, so the longest walks start first
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = hq / hkv;
  const int row0 = (gridDim.z - 1 - blockIdx.z) * kRows;
  const int rows = min(kRows, lq * g - row0);
  const int off = q_offset[b];
  if (tid < kRows) {      // dead rows: zero q, no key, never written
    const int fused = row0 + tid, t = fused / g, member = fused % g;
    const bool live = tid < rows;
    row_off[tid] = live ? ((static_cast<int64_t>(b) * lq + t) * hq + h * g +
                           member) * D
                        : -1;
    row_pos[tid] = live ? off + t : -1;
  }
  __syncthreads();

  // the block's causal span: its first and last rows' positions
  const int top = off + (row0 + rows - 1) / g;
  const int bottom = off + row0 / g;
  const int kvl = kv_len[b];
  int n_keys = min(kvl, top + 1);
  n_keys = max(min(n_keys, table_width * page_size), 0);
  // keys below `clear` are loaded and visible to every live row
  const int clear = min(max(min(kvl, bottom + 1), 0), n_keys);
  const int n_tiles = (n_keys + kKeys - 1) / kKeys;
  const int* trow = table + static_cast<int64_t>(b) * table_width;

  // q rows: 16-byte copies, zeros for the dead rows
#pragma unroll
  for (int i = 0; i < kRows * kChunks / kThreads; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / kChunks, c = e % kChunks;
    const int64_t ro = row_off[r];
    cp_async16(smem_u32(q_s + r * LD + c * 8), q + (ro < 0 ? 0 : ro + c * 8),
               ro < 0 ? 0 : 16);
  }
  // a tile: thread tid copies half of key row tid / 2 of K and of V; rows
  // at or past n_keys are zeros (P is 0 there, and 0 x 0 stays finite)
  auto load_tile = [&](int tile, int buf) {
    const int j = tid >> 1;
    const int kp = tile * kKeys + j;
    const bool live = kp < n_keys;
    int64_t src = 0;
    if (live) {
      int page = trow[kp / page_size];
      page = min(max(page, 0), n_pages - 1);  // never read out of bounds
      src = ((static_cast<int64_t>(page) * page_size + kp % page_size) * hkv +
             h) * D;
    }
    const uint32_t kd = smem_u32(k_s + buf * L::KV + j * LD);
    const uint32_t vd = smem_u32(v_s + buf * L::KV + j * LD);
    const int c0 = (tid & 1) * kHalf;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const int c = c0 + i;
      cp_async16(kd + c * 16, k_pages + src + c * 8, live ? 16 : 0);
      cp_async16(vd + c * 16, v_pages + src + c * 8, live ? 16 : 0);
    }
  };
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();

  const int wrow = warp * 16;
  const int pos0 = row_pos[wrow + gid], pos1 = row_pos[wrow + gid + 8];
  uint32_t qf[KT][4];
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kMaskValue, m1 = kMaskValue, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it == 0) {   // q and tile 0 are in; q moves to registers
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
        ldmatrix_x4(qf[kt], smem_u32(q_s + (wrow + (lane & 7) +
                                            ((lane >> 3) & 1) * 8) * LD +
                                     kt * 16 + (lane >> 4) * 8));
      __syncthreads();              // q's buffer may now take tile 1
    }
    if (it + 1 < n_tiles) {
      load_tile(it + 1, buf ^ 1);   // its buffer was last read before the
      cp_async_commit();            // barrier that ended iteration it - 1
    }
    if (it > 0) {                   // tile it is in
      if (it + 1 < n_tiles)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
    }
    // S = Q K^T (log2 units after scaling)
    const bf16* kb = k_s + buf * L::KV;
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, smem_u32(kb + (np * 16 + (lane & 7) +
                                      ((lane >> 4) << 3)) * LD +
                                kt * 16 + ((lane >> 3) & 1) * 8));
        mma16816(s[2 * np], qf[kt], r[0], r[1]);
        mma16816(s[2 * np + 1], qf[kt], r[2], r[3]);
      }
    }
    const int t0 = it * kKeys;
    if (t0 + kKeys > clear) {   // some key of the tile is masked for a row
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = t0 + n * 8 + 2 * t4 + (e & 1);
          const int pos = e < 2 ? pos0 : pos1;
          s[n][e] = kp < n_keys && kp <= pos ? s[n][e] * scale_log2
                                             : kMaskValue;
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= scale_log2;
      }
    }
    // online softmax over the tile, two rows per thread (a quad per row)
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = exp2f(s[n][0] - mx0);
      s[n][1] = exp2f(s[n][1] - mx0);
      s[n][2] = exp2f(s[n][2] - mx1);
      s[n][3] = exp2f(s[n][3] - mx1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    l0 = l0 * c0 + sum0;   // this thread's columns; summed over the quad
    l1 = l1 * c1 + sum1;   // at the end
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= c0;
      o[n][1] *= c0;
      o[n][2] *= c1;
      o[n][3] *= c1;
    }
    // O += P V: P (bf16, from the S fragment) is the A operand
    const bf16* vb = v_s + buf * L::KV;
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, smem_u32(vb + (kk * 16 + (lane & 7) +
                                            ((lane >> 3) & 1) * 8) * LD +
                                      dp * 16 + (lane >> 4) * 8));
        mma16816(o[2 * dp], pa, r[0], r[1]);
        mma16816(o[2 * dp + 1], pa, r[2], r[3]);
      }
    }
    __syncthreads();   // every warp is done with buffer buf
  }
  cp_async_wait<0>();  // nothing in flight at exit (n_tiles == 0)

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int r0 = wrow + gid, r1 = r0 + 8;
  if (r0 < rows) {
    bf16* dst = out + row_off[r0] + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
  }
  if (r1 < rows) {
    bf16* dst = out + row_off[r1] + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* table, const int* q_offset, const int* kv_len,
                   void* out, int batch, int lq, int hq, int hkv, int n_pages,
                   int page_size, int table_width, cudaStream_t stream) {
  constexpr int smem = Layout<D>::kBytes;
  auto kernel = prefill_tc_kernel<D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(D));
  const int blocks = (lq * (hq / hkv) + kRows - 1) / kRows;
  if (blocks > 65535 || batch > 65535) return cudaErrorInvalidValue;
  kernel<<<dim3(hkv, batch, blocks), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), table, q_offset, kv_len,
      static_cast<bf16*>(out), lq, hq, hkv, n_pages, page_size, table_width,
      scale_log2);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace paged_attn

// The bfloat16 entry point, called by paged_prefill.cu's dispatcher.
cudaError_t paged_prefill_tc_launch(int head_dim, const void* q,
                                    const void* k, const void* v,
                                    const int* table, const int* q_offset,
                                    const int* kv_len, void* out, int batch,
                                    int lq, int hq, int hkv, int n_pages,
                                    int page_size, int table_width,
                                    cudaStream_t stream) {
  using namespace paged_attn::tc;
  switch (head_dim) {
    case 16: return launch<16>(q, k, v, table, q_offset, kv_len, out, batch, lq, hq, hkv, n_pages, page_size, table_width, stream);
    case 64: return launch<64>(q, k, v, table, q_offset, kv_len, out, batch, lq, hq, hkv, n_pages, page_size, table_width, stream);
    case 128: return launch<128>(q, k, v, table, q_offset, kv_len, out, batch, lq, hq, hkv, n_pages, page_size, table_width, stream);
    default: return cudaErrorInvalidValue;
  }
}
