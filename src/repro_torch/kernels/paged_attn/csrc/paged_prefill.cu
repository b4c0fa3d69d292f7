// Paged GQA prefill attention: Lq query tokens per slot at per-slot depth
// q_offset[b], causal over the slot's K/V pages, for sm_90a.  Also the
// speculative verify (Lq = k+1 at the decode depth).
//
// Replaces the TPU kernel src/repro/kernels/paged_attn/prefill_kernel.py
// (`paged_prefill_attn_kernel`, body `_make_kernel`).  Same function: the
// query rows of one KV head are fused as row r = token r / G, group member
// r % G; row r at absolute position q_offset + r / G sees key kpos when
// kpos <= q_offset + r / G and kpos < kv_len; float32 online softmax.
// Unlike the TPU kernel, the queries are not folded by the caller: the
// kernel reads q and writes out in the public [B, Lq, Hq, D] layout and
// computes each fused row's address itself.
//
// What bounds it on an H100: at prompt lengths, operations and bytes are
// close, and operations take over as prompts grow.  Every K/V row is
// reused by up to Lq x G query rows: a join of 8 prompts of 512 tokens
// does 3.8 GFLOP (3.8 us at the bf16 tensor-core peak) against 17 MB of q,
// out and K/V traffic (5.0 us at 3.35 TB/s); the operations grow with the
// square of the prompt and bound the kernel from about 700 tokens up.
//
// What the design does about it: one CTA per (slot, KV head, block of 64
// fused rows) gives B x Hkv x ceil(Lq G / 64) CTAs, enough to fill the
// card's 132 SMs at a join.  Each CTA stops its page walk at
// min(kv_len, causal top of its row block + 1), which skips the pages
// above the block's diagonal, as the TPU kernel's causal skip does.  The
// dtype picks the walk, by a fixed rule: bfloat16, the served dtype, runs
// on the tensor cores (paged_prefill_tc.cu: mma.sync products, cp.async
// K/V ring); float32, the dtype of the card-side agreement runs, keeps the
// shared tile walk of paged_attn_common.cuh on the CUDA cores (TF32 is off
// by the repository's rule, so float32 has no tensor-core product).
#include "paged_attn_common.cuh"

// bfloat16 on the tensor cores (paged_prefill_tc.cu)
cudaError_t paged_prefill_tc_launch(int head_dim, const void* q,
                                    const void* k, const void* v,
                                    const int* table, const int* q_offset,
                                    const int* kv_len, void* out, int batch,
                                    int lq, int hq, int hkv, int n_pages,
                                    int page_size, int table_width,
                                    cudaStream_t stream);

namespace paged_attn {

constexpr int kPrefillTile = 32;   // keys per tile (2 pages of 16)
constexpr int kPrefillRows = 64;   // fused (token, group) rows per CTA

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                     const T* __restrict__ v_pages,
                     const int* __restrict__ table,
                     const int* __restrict__ q_offset,
                     const int* __restrict__ kv_len, T* __restrict__ out,
                     int lq, int hq, int hkv, int n_pages, int page_size,
                     int table_width, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = hq / hkv;
  const int row0 = blockIdx.x * kPrefillRows;
  const int off = q_offset[b];
  RowBlock rb = row_block<D, kPrefillTile, kPrefillRows>(smem);
  rb.rows = min(kPrefillRows, lq * g - row0);
  for (int r = threadIdx.x; r < rb.rows; r += kThreads) {
    const int fused = row0 + r;
    const int t = fused / g, member = fused % g;
    rb.row_off[r] =
        ((static_cast<int64_t>(b) * lq + t) * hq + h * g + member) * D;
    rb.row_pos[r] = off + t;
  }
  __syncthreads();
  // causal top of the block: its last row's position
  const int top = off + (row0 + rb.rows - 1) / g;
  int n_keys = min(kv_len[b], top + 1);
  n_keys = max(min(n_keys, table_width * page_size), 0);
  attend_rows<T, D, kPrefillTile, kPrefillRows>(
      q, out, k_pages, v_pages,
      PagedRows{table + static_cast<int64_t>(b) * table_width, n_pages,
                page_size, hkv, h},
      n_keys, scale, rb, smem);
}

template <typename T, int D>
cudaError_t launch_prefill(const void* q, const void* k, const void* v,
                           const int* table, const int* q_offset,
                           const int* kv_len, void* out, int batch, int lq,
                           int hq, int hkv, int n_pages, int page_size,
                           int table_width, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D, kPrefillTile, kPrefillRows>();
  auto kernel = paged_prefill_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const int blocks = (lq * (hq / hkv) + kPrefillRows - 1) / kPrefillRows;
  kernel<<<dim3(blocks, hkv, batch), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), table, q_offset, kv_len,
      static_cast<T*>(out), lq, hq, hkv, n_pages, page_size, table_width,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_prefill(int head_dim, const void* q, const void* k,
                             const void* v, const int* table,
                             const int* q_offset, const int* kv_len,
                             void* out, int batch, int lq, int hq, int hkv,
                             int n_pages, int page_size, int table_width,
                             cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch_prefill<T, 16>(q, k, v, table, q_offset, kv_len, out, batch, lq, hq, hkv, n_pages, page_size, table_width, stream);
    case 64: return launch_prefill<T, 64>(q, k, v, table, q_offset, kv_len, out, batch, lq, hq, hkv, n_pages, page_size, table_width, stream);
    case 128: return launch_prefill<T, 128>(q, k, v, table, q_offset, kv_len, out, batch, lq, hq, hkv, n_pages, page_size, table_width, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace paged_attn

// Plain C++ entry point for the binding.  Returns the launch status.
cudaError_t paged_prefill_launch(int dtype, int head_dim, const void* q,
                                 const void* k, const void* v,
                                 const int* table, const int* q_offset,
                                 const int* kv_len, void* out, int batch,
                                 int lq, int hq, int hkv, int n_pages,
                                 int page_size, int table_width,
                                 cudaStream_t stream) {
  using namespace paged_attn;
  if (hkv <= 0 || hq % hkv != 0) return cudaErrorInvalidValue;
  if (batch == 0 || lq == 0) return cudaSuccess;
  if (dtype == kFloat32)
    return dispatch_prefill<float>(head_dim, q, k, v, table, q_offset,
                                   kv_len, out, batch, lq, hq, hkv, n_pages,
                                   page_size, table_width, stream);
  if (dtype == kBFloat16)
    return paged_prefill_tc_launch(head_dim, q, k, v, table, q_offset,
                                   kv_len, out, batch, lq, hq, hkv, n_pages,
                                   page_size, table_width, stream);
  return cudaErrorInvalidValue;
}
