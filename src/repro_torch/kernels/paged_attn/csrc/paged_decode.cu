// Paged GQA decode attention: one new query token per slot against the
// slot's K/V pages, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/paged_attn/kernel.py
// (`paged_attn_kernel`, body `_make_kernel`).  Same function: q [B, Hq, D]
// read as [B, Hkv, G, D], pooled pages k/v [N, ps, Hkv, D], table [B, P]
// int32 (entries clamped below N by the caller, and again here), lengths
// [B] int32; float32 online softmax; a slot attends over its first
// n_keys = min(lengths[b], P x ps) keys, no key row at or past n_keys is
// read, and a slot of length 0 gives zeros.
//
// What bounds it on an H100: device-memory bytes, and at serving batch
// sizes the latency of few, dependent loads.  A decode step reads every
// live K and V row once (live rows x Hkv x D x 2 bytes in bf16, x2 for K
// and V) and does 4 x G x D flops per row, about 3.5 flops per byte at
// G=7, D=64: two orders of magnitude under the ~295 flops/byte where the
// tensor cores would become the limit.  At qwen2-0.5b's batch 8 that is
// about 1.5 MB a call, 0.45 us at 3.35 TB/s: a walk of one CTA per (slot,
// KV head) (16 CTAs on 132 SMs) is bound by its chain of loads instead.
//
// What the design does about it: the split-KV walk of decode_split.cuh.
// `splits` CTAs per (slot, KV head, pair of query heads), one cluster,
// share the slot's keys and merge their softmax states through
// distributed shared memory in the same launch; split.py picks `splits`
// from the batch, the KV heads, G, the table's width and a CTA target an
// SM (8 at the qwen serve shape with the default target of 2: 512 CTAs).
// A few query rows a CTA (cta_rows: 1, 2 or 4, two by default; a template
// argument, GMAX, of the kernel) keep each lane's serial work per key
// short; the G / cta_rows CTAs of a KV head read the same K/V rows, which
// L2 can serve after the first read.  The CTA target and cta_rows are the
// launch knobs the autotuner sweeps (split.py, autotune.py).  Each CTA
// stages the page ids of its range in shared memory once, keeps q in
// registers, and keeps kUnroll warp-steps of 16-byte K/V loads in flight
// per warp.  Pages past
// every slot's length are pruned by the caller, which slices the table to
// a power-of-two page bucket.
#include "decode_split.cuh"

namespace paged_attn {

template <typename T, int D, int GMAX>
__global__ void __launch_bounds__(split::kBlock)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int hq, int hkv, int n_pages, int page_size,
                    int table_width, float qscale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = hq / hkv;
  const int groups = (g + GMAX - 1) / GMAX;   // CTAs sharing the G rows
  const int b = blockIdx.y, h = blockIdx.z / groups;
  const int r0 = blockIdx.z % groups * GMAX;  // this CTA's first row
  const int n_keys = min(max(lengths[b], 0), table_width * page_size);
  const split::StagedPages keys{
      PagedRows{table + static_cast<int64_t>(b) * table_width, n_pages,
                page_size, hkv, h},
      reinterpret_cast<int*>(smem), 0};
  split::decode_walk<T, D, GMAX>(
      q, out, k_pages, v_pages, keys,
      (static_cast<int64_t>(b) * hq + static_cast<int64_t>(h) * g + r0) * D,
      min(GMAX, g - r0), n_keys, qscale, smem);
}

template <typename T, int D, int GMAX>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const int* table, const int* lengths, void* out,
                          int batch, int hq, int hkv, int n_pages,
                          int page_size, int table_width, int splits,
                          int cta_rows, cudaStream_t stream) {
  const float qscale = split::kLog2e / sqrtf(static_cast<float>(D));
  return split::launch_clusters(
      paged_decode_kernel<T, D, GMAX>, splits, batch,
      hkv * split::row_groups(hq / hkv, cta_rows),
      split::smem_bytes<D, GMAX, true>(), stream, q, k, v, table, lengths,
      out, hq, hkv, n_pages, page_size, table_width, qscale);
}

// one case for each rows a CTA keeps: cta_rows is 1, 2 or 4
template <typename T, int D>
cudaError_t dispatch_group(const void* q, const void* k, const void* v,
                           const int* table, const int* lengths, void* out,
                           int batch, int hq, int hkv, int n_pages,
                           int page_size, int table_width, int splits,
                           int cta_rows, cudaStream_t stream) {
  switch (split::group_rows(hq / hkv, cta_rows)) {
    case 1: return launch_decode<T, D, 1>(q, k, v, table, lengths, out, batch, hq, hkv, n_pages, page_size, table_width, splits, cta_rows, stream);
    case 2: return launch_decode<T, D, 2>(q, k, v, table, lengths, out, batch, hq, hkv, n_pages, page_size, table_width, splits, cta_rows, stream);
    case 4: return launch_decode<T, D, 4>(q, k, v, table, lengths, out, batch, hq, hkv, n_pages, page_size, table_width, splits, cta_rows, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_decode(int head_dim, const void* q, const void* k,
                            const void* v, const int* table,
                            const int* lengths, void* out, int batch, int hq,
                            int hkv, int n_pages, int page_size,
                            int table_width, int splits, int cta_rows,
                            cudaStream_t stream) {
  switch (head_dim) {
    case 16: return dispatch_group<T, 16>(q, k, v, table, lengths, out, batch, hq, hkv, n_pages, page_size, table_width, splits, cta_rows, stream);
    case 64: return dispatch_group<T, 64>(q, k, v, table, lengths, out, batch, hq, hkv, n_pages, page_size, table_width, splits, cta_rows, stream);
    case 128: return dispatch_group<T, 128>(q, k, v, table, lengths, out, batch, hq, hkv, n_pages, page_size, table_width, splits, cta_rows, stream);
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
                                int splits, int cta_rows,
                                cudaStream_t stream) {
  using namespace paged_attn;
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > split::kMaxGroup ||
      n_pages <= 0 || page_size <= 0 ||
      (cta_rows != 1 && cta_rows != 2 && cta_rows != 4))
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  if (dtype == kFloat32)
    return dispatch_decode<float>(head_dim, q, k, v, table, lengths, out,
                                  batch, hq, hkv, n_pages, page_size,
                                  table_width, splits, cta_rows, stream);
  if (dtype == kBFloat16)
    return dispatch_decode<__nv_bfloat16>(head_dim, q, k, v, table, lengths,
                                          out, batch, hq, hkv, n_pages,
                                          page_size, table_width, splits,
                                          cta_rows, stream);
  return cudaErrorInvalidValue;
}
