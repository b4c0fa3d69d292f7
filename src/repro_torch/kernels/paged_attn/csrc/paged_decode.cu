// Paged GQA decode attention: one new query token per slot against the
// slot's K/V pages, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/paged_attn/kernel.py
// (`paged_attn_kernel`, body `_make_kernel`).  Same function: q [B, Hq, D]
// read as [B, Hkv, G, D], pooled pages k/v [N, ps, Hkv, D], table [B, P]
// int32 (entries clamped below N by the caller, and again here), lengths
// [B] int32; float32 online softmax; keys at or past lengths[b] are never
// read.
//
// What bounds it on an H100: device-memory bytes.  A decode step reads
// every live K and V row once (live rows x Hkv x D x 2 bytes in bf16, x2
// for K and V) and does 4 x G x D flops per row, about 3.5 flops per byte
// at G=7, D=64: two orders of magnitude under the ~295 flops/byte where
// the tensor cores would become the limit.
//
// What the design does about it: one CTA per (slot, KV head) keeps the G
// query rows of that head resident, so each K/V row is fetched from device
// memory once and serves all G query heads (the GQA fold of the TPU
// kernel).  The page walk stops at the slot's own length (ceil(len/ps)
// pages), and each page id is loaded from the table inside the CTA, which
// replaces the TPU kernel's scalar prefetch.  Pages past every slot's
// length are pruned by the caller, which slices the table to a
// power-of-two page bucket.  With B x Hkv CTAs (16 at batch 8 on
// qwen2-0.5b) the card is far from full; splitting the walk over CTAs
// (flash-decoding) is left for a later change.
#include "paged_attn_common.cuh"

namespace paged_attn {

constexpr int kDecodeTile = 64;   // keys per tile (4 pages of 16)
constexpr int kDecodeRows = 16;   // most query heads per KV head (G)

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int hq, int hkv, int n_pages, int page_size,
                    int table_width, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int g = hq / hkv;
  const int len = max(lengths[b], 0);
  RowBlock rb = row_block<D, kDecodeTile, kDecodeRows>(smem);
  rb.rows = g;
  for (int r = threadIdx.x; r < g; r += kThreads) {
    rb.row_off[r] = (static_cast<int64_t>(b) * hq + h * g + r) * D;
    rb.row_pos[r] = len - 1;     // the new token sees the whole prefix
  }
  __syncthreads();
  const int n_keys = min(len, table_width * page_size);
  attend_rows<T, D, kDecodeTile, kDecodeRows>(
      q, out, k_pages, v_pages, table + static_cast<int64_t>(b) * table_width,
      n_pages, page_size, hkv, h, n_keys, scale, rb, smem);
}

template <typename T, int D>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const int* table, const int* lengths, void* out,
                          int batch, int hq, int hkv, int n_pages,
                          int page_size, int table_width,
                          cudaStream_t stream) {
  constexpr int smem = smem_bytes<D, kDecodeTile, kDecodeRows>();
  auto kernel = paged_decode_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  kernel<<<dim3(batch, hkv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), table, lengths, static_cast<T*>(out), hq,
      hkv, n_pages, page_size, table_width, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_decode(int head_dim, const void* q, const void* k,
                            const void* v, const int* table,
                            const int* lengths, void* out, int batch, int hq,
                            int hkv, int n_pages, int page_size,
                            int table_width, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch_decode<T, 16>(q, k, v, table, lengths, out, batch, hq, hkv, n_pages, page_size, table_width, stream);
    case 64: return launch_decode<T, 64>(q, k, v, table, lengths, out, batch, hq, hkv, n_pages, page_size, table_width, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace paged_attn

// Plain C++ entry point for the binding (no PyTorch headers here, so this
// file compiles in seconds).  Returns the launch status.
cudaError_t paged_decode_launch(int dtype, int head_dim, const void* q,
                                const void* k, const void* v,
                                const int* table, const int* lengths,
                                void* out, int batch, int hq, int hkv,
                                int n_pages, int page_size, int table_width,
                                cudaStream_t stream) {
  using namespace paged_attn;
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > kDecodeRows)
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  if (dtype == kFloat32)
    return dispatch_decode<float>(head_dim, q, k, v, table, lengths, out,
                                  batch, hq, hkv, n_pages, page_size,
                                  table_width, stream);
  if (dtype == kBFloat16)
    return dispatch_decode<__nv_bfloat16>(head_dim, q, k, v, table, lengths,
                                          out, batch, hq, hkv, n_pages,
                                          page_size, table_width, stream);
  return cudaErrorInvalidValue;
}
