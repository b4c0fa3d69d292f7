// Sparsity-aware skinny GEMM, C[M, N] = A[M, K] @ B[K, N] in float32, for
// sm_90a: the paper's "inspect the operand, skip the command" (§5.1.2) at
// the granularity of a k-block of `bk` rows of B.  This is the CUDA-core
// walk; the wrapper (kernel.py, `route`) sends bfloat16 calls whose rows of
// A are whole 16 bytes, on 16-byte aligned bases, with bk % 16 == 0 to the
// tensor-core walk of ss_gemm_tc.cu instead, and everything else (float32,
// a ragged K, unaligned views) here.
//
// Replaces the two TPU kernels of src/repro/kernels/ss_gemm/kernel.py:
//  * `ssgemm_masked_kernel`: a static walk over every k-block that skips
//    the product of each block whose `block_mask` entry is 0 (scalar
//    prefetch plus `pl.when` on the TPU).  Here the mask walk tests
//    mask[kb] before it touches the block: a skipped block loads nothing of
//    A and nothing of B.
//  * `ssgemm_compact_kernel`: a walk over a compacted list of live k-block
//    ids, up to a budget, where the index maps chase the prefetched list
//    and trailing steps repeat the last live id.  Here the list walk visits
//    idx[j] for j < n_live, with n_live read from device memory (no host
//    read); the repeated tail is simply not walked.
// Both walks share one kernel body; the walk is a functor (walk.cuh), as
// the key-row functors of ../../paged_attn/csrc/paged_attn_common.cuh.
//
// What bounds it on an H100.  The function is bytes-bound: each live k-block
// of A is read once (M x live columns x 2 bytes in bf16, 128 MiB at the
// paper's M 16,384 x K 4,096) for 2 x N flops per element, at most 16 flops
// per byte at N 16.  This walk does not reach that bound at N 16: every
// element of A is widened to float32 and takes N `fmaf`s against B's
// float32 copy in shared memory, B is restaged for every 32 rows, and a
// warp ends with R x N shuffle sums.  It is issue-bound there: 0.151 ms for
// 2.15 GFLOP on an H100 80GB HBM3 at 700 W, 14 TFLOP/s and 27% of the bytes
// bound.  At N 4 a warp takes 8 rows and the walk reaches about 74% of it.
//
// What the design does.  A is row-major with K contiguous, so a
// warp owns R rows (8 for N <= 8, 4 for N 16) and its lanes take 16-byte
// chunks along K: a k-block row of 256 bf16 values is one coalesced
// 512-byte request per row, and a lane issues all R of its row loads before
// it multiplies.  The k-block of B (at most 256 x N at a time) is staged in
// shared memory as float32 in the order the lanes read it, with the rows of
// neighbouring lanes `LS` floats apart (LS padded so that vector reads from
// shared memory are free of bank conflicts).  Each lane keeps R x N float32
// partial sums over the whole walk; a warp-shuffle sum reduces them once at
// the end and each [R, N] tile of C is written once.  Rows at or past M are
// neither read nor written.  The K tail is bounds-checked: no column at or
// past K is read.  Where K, bk or the address of A is not a multiple of 16
// bytes, the lanes take one element each instead of 16 bytes (same walk,
// still coalesced).
#include "../../paged_attn/csrc/paged_attn_common.cuh"
#include "walk.cuh"

namespace ss_gemm {
using paged_attn::kBFloat16;
using paged_attn::kFloat32;
using paged_attn::to_f32;
using paged_attn::warp_sum;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStage = 256;  // rows of B staged in shared memory at a time
constexpr int kMaxWidth = 16;

template <int NP>
struct Tile {
  static constexpr int kRows = NP >= 16 ? 4 : 8;              // rows per warp
  static constexpr int kLaneStride = NP <= 4 ? NP : NP + 4;   // floats
};

// Shared-memory slot of row `kk` of a staged piece of B, in the order the
// lanes read it: lane l at iteration `it` takes the V elements of chunk
// it * 32 + l, and element e of that chunk sits at slot (it * V + e) * 32 + l.
template <int V>
__device__ __forceinline__ int slot(int kk) {
  const int c = kk / V, e = kk % V;
  return ((c / 32) * V + e) * 32 + c % 32;
}

template <int NP>
__device__ __forceinline__ void load_b(const float* p, float* bv) {
  if constexpr (NP % 4 == 0) {
#pragma unroll
    for (int n = 0; n < NP; n += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + n);
      bv[n] = x.x;
      bv[n + 1] = x.y;
      bv[n + 2] = x.z;
      bv[n + 3] = x.w;
    }
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    bv[0] = x.x;
    bv[1] = x.y;
  }
}

// Element e of a 16-byte chunk of A, widened to float32.
__device__ __forceinline__ float chunk_elem(const uint4& raw, int e, float) {
  return reinterpret_cast<const float*>(&raw)[e];
}
__device__ __forceinline__ float chunk_elem(const uint4& raw, int e,
                                            __nv_bfloat16) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&raw)[e]);
}

template <typename T, int NP, bool VEC, typename Walk>
__global__ void __launch_bounds__(kThreads)
ssgemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
              float* __restrict__ out, int m, int k, int n, int bk,
              Walk walk) {
  constexpr int R = Tile<NP>::kRows;
  constexpr int LS = Tile<NP>::kLaneStride;
  constexpr int V = VEC ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int kIters = kStage / (32 * V);
  static_assert(kStage % (32 * V) == 0, "a piece is whole lane chunks");
  __shared__ __align__(16) float b_s[kStage * LS];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row0 =
      (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * R;
  bool live[R];
#pragma unroll
  for (int r = 0; r < R; ++r) live[r] = row0 + r < m;
  float acc[R][NP];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < NP; ++c) acc[r][c] = 0.f;

  const int steps = walk.steps();
  for (int j = 0; j < steps; ++j) {
    const int kb = walk.block(j);
    if (kb < 0) continue;  // skipped: nothing of A or B is loaded
    const int kb0 = kb * bk;
    const int kb1 = min(kb0 + bk, k);
    for (int p0 = kb0; p0 < kb1; p0 += kStage) {
      const int len = min(kStage, kb1 - p0);
      __syncthreads();  // the previous piece has been read
      for (int t = threadIdx.x; t < len * NP; t += kThreads) {
        const int kk = t / NP, c = t % NP;
        b_s[slot<V>(kk) * LS + c] =
            c < n ? to_f32(b[static_cast<int64_t>(p0 + kk) * n + c]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int it = 0; it < kIters; ++it) {
        const int kk = (it * 32 + lane) * V;  // first column of this chunk
        if (kk < len) {
          if constexpr (VEC) {
            uint4 raw[R];
#pragma unroll
            for (int r = 0; r < R; ++r)
              raw[r] = live[r] ? *reinterpret_cast<const uint4*>(
                                     a + (row0 + r) * k + p0 + kk)
                               : make_uint4(0, 0, 0, 0);
#pragma unroll
            for (int e = 0; e < V; ++e) {
              float bv[NP];
              load_b<NP>(b_s + ((it * V + e) * 32 + lane) * LS, bv);
#pragma unroll
              for (int r = 0; r < R; ++r) {
                const float x = chunk_elem(raw[r], e, T{});
#pragma unroll
                for (int c = 0; c < NP; ++c)
                  acc[r][c] = fmaf(x, bv[c], acc[r][c]);
              }
            }
          } else {
            float x[R];
#pragma unroll
            for (int r = 0; r < R; ++r)
              x[r] = live[r] ? to_f32(a[(row0 + r) * k + p0 + kk]) : 0.f;
            float bv[NP];
            load_b<NP>(b_s + (it * 32 + lane) * LS, bv);
#pragma unroll
            for (int r = 0; r < R; ++r)
#pragma unroll
              for (int c = 0; c < NP; ++c)
                acc[r][c] = fmaf(x[r], bv[c], acc[r][c]);
          }
        }
      }
    }
  }

  // One warp-shuffle sum per output; lane (r * NP + c) % 32 writes it.
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < NP; ++c) {
      const float v = warp_sum(acc[r][c]);
      if (lane == (r * NP + c) % 32 && live[r] && c < n)
        out[(row0 + r) * n + c] = v;
    }
}

template <typename T, int NP, typename Walk>
cudaError_t launch_width(const void* a, const void* b, float* out, int m,
                         int k, int n, int bk, Walk walk, bool vec,
                         cudaStream_t stream) {
  constexpr int rows = kWarps * Tile<NP>::kRows;
  const dim3 grid((m + rows - 1) / rows);
  const T* at = static_cast<const T*>(a);
  const T* bt = static_cast<const T*>(b);
  if (vec)
    ssgemm_kernel<T, NP, true, Walk>
        <<<grid, kThreads, 0, stream>>>(at, bt, out, m, k, n, bk, walk);
  else
    ssgemm_kernel<T, NP, false, Walk>
        <<<grid, kThreads, 0, stream>>>(at, bt, out, m, k, n, bk, walk);
  return cudaGetLastError();
}

template <typename T, typename Walk>
cudaError_t launch_typed(const void* a, const void* b, float* out, int m,
                         int k, int n, int bk, Walk walk, cudaStream_t stream) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const bool vec = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   k % kVec == 0 && bk % kVec == 0;
  if (n <= 2) return launch_width<T, 2>(a, b, out, m, k, n, bk, walk, vec, stream);
  if (n <= 4) return launch_width<T, 4>(a, b, out, m, k, n, bk, walk, vec, stream);
  if (n <= 8) return launch_width<T, 8>(a, b, out, m, k, n, bk, walk, vec, stream);
  return launch_width<T, 16>(a, b, out, m, k, n, bk, walk, vec, stream);
}

template <typename Walk>
cudaError_t launch(int dtype, const void* a, const void* b, float* out, int m,
                   int k, int n, int bk, Walk walk, cudaStream_t stream) {
  if (m < 0 || k < 1 || n < 1 || n > kMaxWidth || bk < 1)
    return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  if (dtype == kFloat32)
    return launch_typed<float>(a, b, out, m, k, n, bk, walk, stream);
  if (dtype == kBFloat16)
    return launch_typed<__nv_bfloat16>(a, b, out, m, k, n, bk, walk, stream);
  return cudaErrorInvalidValue;
}

}  // namespace ss_gemm

// Plain C++ entry points for the binding (no PyTorch headers here).  Each
// returns the launch status.  a [M, K] and b [K, N] (N <= 16) in one dtype,
// out [M, N] float32; nk = ceil(K / bk) k-blocks.
cudaError_t ssgemm_masked_launch(int dtype, const void* a, const void* b,
                                 const int* mask, float* out, int m, int k,
                                 int n, int bk, cudaStream_t stream) {
  using namespace ss_gemm;
  const int nk = bk > 0 ? (k + bk - 1) / bk : 0;
  return launch(dtype, a, b, out, m, k, n, bk, MaskWalk{mask, nk}, stream);
}

cudaError_t ssgemm_compact_launch(int dtype, const void* a, const void* b,
                                  const int* idx, const int* n_live,
                                  int budget, float* out, int m, int k, int n,
                                  int bk, cudaStream_t stream) {
  using namespace ss_gemm;
  if (budget < 1) return cudaErrorInvalidValue;
  const int nk = bk > 0 ? (k + bk - 1) / bk : 0;
  return launch(dtype, a, b, out, m, k, n, bk,
                ListWalk{idx, n_live, budget, nk}, stream);
}
