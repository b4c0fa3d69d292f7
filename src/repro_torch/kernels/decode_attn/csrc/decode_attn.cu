// Dense-stripe GQA decode attention: one new query token per slot against
// the slot's contiguous K/V stripe, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/decode_attn/kernel.py
// (`decode_attn_kernel`, body `_make_kernel`).  Same function: q [B, Hq, D]
// read as [B, Hkv, G, D], stripes k/v [B, S, Hkv, D], lengths [B] int32;
// float32 online softmax (m, l, acc), output written once, a slot with
// length 0 gives zeros (acc / max(l, 1e-30)).  The TPU kernel skips every
// 512-row block at or past the slot's length before loading it (scalar
// prefetch) and its caller prunes the grid to `s_cap` rows; here a slot's
// walk covers its first n_keys = min(lengths[b], s_cap) rows, so no key
// row at or past it is ever loaded.  `s_cap` lets the caller pass the
// whole stripe (batch stride S x Hkv x D) instead of a sliced copy: a
// row-bounded view of a [B, S, Hkv, D] stripe is not contiguous, and
// copying it would cost a stripe's worth of traffic per layer per step.
//
// What bounds it on an H100: device-memory bytes, and at serving batch
// sizes the latency of few, dependent loads.  Each live K and V row is
// read once (live rows x Hkv x D x 2 bytes in bf16, x2 for K and V) for
// 4 x G x D flops per row, about 3.5 flops per byte at G=7, D=64: two
// orders of magnitude under the ~295 flops/byte where the tensor cores
// would become the limit.  With one CTA per (slot, KV head), 16 at batch 8
// on qwen2-0.5b, the chain of loads of each CTA's walk sets the time.
//
// What the design does about it: the split-KV walk of
// ../../paged_attn/csrc/decode_split.cuh, shared with the paged decode
// kernel, with a fixed stripe stride in place of the staged page ids.
// `splits` CTAs per (slot, KV head, pair of query heads), one cluster,
// share the slot's rows and merge their softmax states through
// distributed shared memory in the same launch (split.py picks `splits`
// from the batch, the KV heads, G and s_cap).  Two query rows a CTA keep
// each lane's serial work per key short; the G / 2 CTAs of a KV head read
// the same K/V rows, which L2 can serve after the first read.  q stays in
// registers, and each warp keeps kUnroll warp-steps of 16-byte K/V loads
// in flight.
#include "../../paged_attn/csrc/decode_split.cuh"

namespace decode_attn {
using namespace paged_attn;

template <typename T, int D, int GMAX>
__global__ void __launch_bounds__(split::kBlock)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ lengths,
                   T* __restrict__ out, int hq, int hkv, int s, int s_cap,
                   float qscale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = hq / hkv;
  const int groups = (g + GMAX - 1) / GMAX;   // CTAs sharing the G rows
  const int b = blockIdx.y, h = blockIdx.z / groups;
  const int r0 = blockIdx.z % groups * GMAX;  // this CTA's first row
  const int n_keys = min(max(lengths[b], 0), s_cap);
  const split::Stripe keys{
      StripeRows{static_cast<int64_t>(b) * s * hkv + h, hkv}};
  split::decode_walk<T, D, GMAX>(
      q, out, k, v, keys,
      (static_cast<int64_t>(b) * hq + static_cast<int64_t>(h) * g + r0) * D,
      min(GMAX, g - r0), n_keys, qscale, smem);
}

template <typename T, int D, int GMAX>
cudaError_t launch_stripe(const void* q, const void* k, const void* v,
                          const int* lengths, void* out, int batch, int hq,
                          int hkv, int s, int s_cap, int splits,
                          cudaStream_t stream) {
  const float qscale = split::kLog2e / sqrtf(static_cast<float>(D));
  return split::launch_clusters(
      decode_attn_kernel<T, D, GMAX>, splits, batch,
      hkv * split::row_groups(hq / hkv),
      split::smem_bytes<D, GMAX, false>(), stream, q, k, v, lengths, out, hq,
      hkv, s, s_cap, qscale);
}

static_assert(split::kCtaRows == 2, "one case for each row count");

template <typename T, int D>
cudaError_t dispatch_group(const void* q, const void* k, const void* v,
                           const int* lengths, void* out, int batch, int hq,
                           int hkv, int s, int s_cap, int splits,
                           cudaStream_t stream) {
  switch (split::group_rows(hq / hkv)) {
    case 1: return launch_stripe<T, D, 1>(q, k, v, lengths, out, batch, hq, hkv, s, s_cap, splits, stream);
    case 2: return launch_stripe<T, D, 2>(q, k, v, lengths, out, batch, hq, hkv, s, s_cap, splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_stripe(int head_dim, const void* q, const void* k,
                            const void* v, const int* lengths, void* out,
                            int batch, int hq, int hkv, int s, int s_cap,
                            int splits, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return dispatch_group<T, 16>(q, k, v, lengths, out, batch, hq, hkv, s, s_cap, splits, stream);
    case 64: return dispatch_group<T, 64>(q, k, v, lengths, out, batch, hq, hkv, s, s_cap, splits, stream);
    case 128: return dispatch_group<T, 128>(q, k, v, lengths, out, batch, hq, hkv, s, s_cap, splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace decode_attn

// Plain C++ entry point for the binding (no PyTorch headers here).
// Returns the launch status.
cudaError_t decode_attn_launch(int dtype, int head_dim, const void* q,
                               const void* k, const void* v,
                               const int* lengths, void* out, int batch,
                               int hq, int hkv, int s, int s_cap, int splits,
                               cudaStream_t stream) {
  using namespace decode_attn;
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > split::kMaxGroup ||
      s_cap < 0 || s_cap > s)
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  if (dtype == kFloat32)
    return dispatch_stripe<float>(head_dim, q, k, v, lengths, out, batch, hq,
                                  hkv, s, s_cap, splits, stream);
  if (dtype == kBFloat16)
    return dispatch_stripe<__nv_bfloat16>(head_dim, q, k, v, lengths, out,
                                          batch, hq, hkv, s, s_cap, splits,
                                          stream);
  return cudaErrorInvalidValue;
}
