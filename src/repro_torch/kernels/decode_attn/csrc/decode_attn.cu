// Dense-stripe GQA decode attention: one new query token per slot against
// the slot's contiguous K/V stripe, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/decode_attn/kernel.py
// (`decode_attn_kernel`, body `_make_kernel`).  Same function: q [B, Hq, D]
// read as [B, Hkv, G, D], stripes k/v [B, S, Hkv, D], lengths [B] int32;
// float32 online softmax (m, l, acc), output written once, a slot with
// length 0 gives zeros (acc / max(l, 1e-30)).  The TPU kernel skips every
// 512-row block at or past the slot's length before loading it (scalar
// prefetch) and its caller prunes the grid to `s_cap` rows; here the walk
// of each CTA ends at min(lengths[b], s_cap), so no key row at or past it
// is ever loaded.  `s_cap` lets the caller pass the whole stripe (batch
// stride S x Hkv x D) instead of a sliced copy: a row-bounded view of a
// [B, S, Hkv, D] stripe is not contiguous, and copying it would cost a
// stripe's worth of traffic per layer per step.
//
// What bounds it on an H100: device-memory bytes.  Each live K and V row
// is read once (live rows x Hkv x D x 2 bytes in bf16, x2 for K and V) for
// 4 x G x D flops per row, about 3.5 flops per byte at G=7, D=64: two
// orders of magnitude under the ~295 flops/byte where the tensor cores
// would become the limit.
//
// What the design does about it: the tile walk, staging and online softmax
// are the paged decode kernel's (paged_attn_common.cuh), with a stripe
// offset in place of the page-table lookup.  One CTA per (slot, KV head)
// keeps the G query rows of that head resident, so each K/V row is fetched
// once for all G query heads, with 16-byte loads.  With B x Hkv CTAs (16 at
// batch 8 on qwen2-0.5b) the card is far from full; splitting the walk over
// CTAs (flash-decoding with a combine step) is left for a later change.
#include "../../paged_attn/csrc/paged_attn_common.cuh"

namespace decode_attn {
using namespace paged_attn;

constexpr int kStripeTile = 64;   // keys per tile
constexpr int kStripeRows = 16;   // most query heads per KV head (G)

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ lengths,
                   T* __restrict__ out, int hq, int hkv, int s, int s_cap,
                   float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int g = hq / hkv;
  const int n_keys = min(max(lengths[b], 0), s_cap);
  RowBlock rb = row_block<D, kStripeTile, kStripeRows>(smem);
  rb.rows = g;
  for (int r = threadIdx.x; r < g; r += kThreads) {
    rb.row_off[r] = (static_cast<int64_t>(b) * hq + h * g + r) * D;
    rb.row_pos[r] = n_keys - 1;  // the new token sees every walked key
  }
  __syncthreads();
  attend_rows<T, D, kStripeTile, kStripeRows>(
      q, out, k, v,
      StripeRows{static_cast<int64_t>(b) * s * hkv + h, hkv}, n_keys, scale,
      rb, smem);
}

template <typename T, int D>
cudaError_t launch_stripe(const void* q, const void* k, const void* v,
                          const int* lengths, void* out, int batch, int hq,
                          int hkv, int s, int s_cap, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D, kStripeTile, kStripeRows>();
  auto kernel = decode_attn_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  kernel<<<dim3(batch, hkv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), hq, hkv, s,
      s_cap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_stripe(int head_dim, const void* q, const void* k,
                            const void* v, const int* lengths, void* out,
                            int batch, int hq, int hkv, int s, int s_cap,
                            cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch_stripe<T, 16>(q, k, v, lengths, out, batch, hq, hkv, s, s_cap, stream);
    case 64: return launch_stripe<T, 64>(q, k, v, lengths, out, batch, hq, hkv, s, s_cap, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace decode_attn

// Plain C++ entry point for the binding (no PyTorch headers here).
// Returns the launch status.
cudaError_t decode_attn_launch(int dtype, int head_dim, const void* q,
                               const void* k, const void* v,
                               const int* lengths, void* out, int batch,
                               int hq, int hkv, int s, int s_cap,
                               cudaStream_t stream) {
  using namespace decode_attn;
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > kStripeRows || s_cap < 0 ||
      s_cap > s)
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  if (dtype == kFloat32)
    return dispatch_stripe<float>(head_dim, q, k, v, lengths, out, batch, hq,
                                  hkv, s, s_cap, stream);
  if (dtype == kBFloat16)
    return dispatch_stripe<__nv_bfloat16>(head_dim, q, k, v, lengths, out,
                                          batch, hq, hkv, s, s_cap, stream);
  return cudaErrorInvalidValue;
}
