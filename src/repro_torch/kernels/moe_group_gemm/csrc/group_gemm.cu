// Sparsity-aware grouped expert GEMM for sm_90a: out[e] = xe[e] @ w[e] in
// float32, one product per expert, with the rows at or past counts[e] set
// to zero.  The paper's "skip the command for a zero operand" (§5.1.2) at
// the granularity of a tile of capacity rows.
//
// Replaces the TPU kernel src/repro/kernels/moe_group_gemm/kernel.py
// (`group_gemm_kernel`, body `_kernel`).  Same function: xe [E, C, D] and
// w [E, D, F] in float32 or bfloat16 (one dtype), counts [E] int32 ->
// out [E, C, F] float32.  On the TPU one grid step takes one (expert,
// 128-row tile); `pl.when` skips the MXU product of a tile past the count
// and writes zeros, and the weight block's repeated index map elides the
// skipped steps' weight copies.
//
// What bounds it on an H100.  At decode (C 1 at batch 8 on moonshot) it is
// bound by the bytes of the live experts' weights: each live expert's D x F
// block is read once (5.8 MB in bf16 at D 2048, F 1408) for two flops per
// weight.  At a 4,096-token join (C 480) the bytes bound it too, with the
// operations just under them (group_gemm_sm90.cu has the numbers).
//
// What the design does about it.  The calls of a join in bfloat16 (C >
// 16) go to group_gemm_sm90.cu: wgmma tiles fed by TMA through a ring of
// K stages (see there).  This file keeps decode (C <= 16) and float32.
// The grid is (F tiles, C tiles, E); each CTA owns BM capacity rows x 64
// output columns of one expert and reads counts[e] first.  A tile whose
// first row is at or past the count writes its zeros and returns before it
// touches xe or w: a dead expert costs one count read per CTA and its zero
// rows, and no weight byte.  A live tile walks K in chunks of 128 bytes a
// row, staged in shared memory through a register prefetch of the next
// chunk (two buffers, one barrier a chunk); rows at or past the count are
// not read (zeros are staged) and are written as zeros.  At decode C is 1,
// so BM is 16 and one expert's weight block is streamed by F / 64 CTAs side
// by side (22 for the gate and up projections), all of them resident at
// once: the weight bytes, not the products, set the time, and this design
// reaches 73-79% of that bound.  bfloat16 products run on the tensor cores
// through `nvcuda::wmma` (16x16x16 fragments, float32 accumulators): a
// 16-row fragment wastes 15 rows at C 1, which costs nothing where the
// weight bytes bound the kernel.  float32 products run as plain FMA tiles
// on the CUDA cores (no TF32), with BM 64.  Operands move in 16-byte
// loads: rows of D and F are whole 16-byte multiples and both bases are
// 16-byte aligned, which the wrapper requires.  Reads past C, D and F are
// guarded.  Where asked (a non-null `tiles`), each CTA adds one to tiles[0]
// and each skipped one to tiles[1], so a caller can read what was skipped.
//
// The backward's dxe[e] = dy[e] @ w[e]^T runs the same tiles for float32
// and for bfloat16 slabs of up to 16 rows (the bfloat16 join's runs in
// group_gemm_sm90.cu), reading w as it lies through a template flag (WT):
// a B chunk is staged 16 bytes along K of each output column, and the
// products read it column-major, so no transposed copy of w is made.
// group_gemm_dy_kernel is the backward's first pass for every route: it
// reads float32 dy's live rows once and writes them in the working dtype,
// zeros past each count (never multiplied: the forward defines those rows
// as 0, so nothing flows through them, NaN included); bytes bound it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace group_gemm {

constexpr int kThreads = 128;  // four warps
constexpr int kBN = 64;        // output columns per CTA
constexpr int kChunk = 128;    // bytes of K staged per row and chunk

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// WT: w[e] is read as [N, K] (dxe's w^T), staged column by column.
template <typename T, int BM, bool WT>
struct Tile {
  static constexpr int V = 16 / static_cast<int>(sizeof(T));  // per 16 B
  static constexpr int BK = kChunk / static_cast<int>(sizeof(T));
  static constexpr int LDA = BK + V;   // padded rows, 16-byte multiples
  static constexpr int LDB = WT ? BK + V : kBN + V;
  static constexpr int LDC = kBN + 4;  // float epilogue tile
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int B_ELEMS = (WT ? kBN : BK) * LDB;
  // 16-byte chunks per thread and chunk of K
  static constexpr int A_VEC = BM * BK / V / kThreads;
  static constexpr int B_VEC = BK * kBN / V / kThreads;
  static constexpr int kOperandBytes =
      2 * (A_ELEMS + B_ELEMS) * static_cast<int>(sizeof(T));
  static constexpr int kEpilogueBytes = BM * LDC * 4;
  static constexpr int kSmemBytes =
      kOperandBytes > kEpilogueBytes ? kOperandBytes : kEpilogueBytes;
  static_assert(BM * BK % (V * kThreads) == 0, "A chunk splits evenly");
  static_assert(BK * kBN % (V * kThreads) == 0, "B chunk splits evenly");
};

// One expert's view: where its rows and weights start and how much is live.
// d is the K walked and f the output columns (dxe: F and D).
template <typename T>
struct Operands {
  const T* x;  // xe[e], [C, D] (dxe: dy[e], [C, F])
  const T* w;  // w[e], [D, F] (dxe: the same w[e], read as [N, K])
  int c0, n0, live, d, f;
};

// The next chunk of K, held in registers between its load and its store.
template <typename T, int BM, bool WT>
struct Stage {
  using TL = Tile<T, BM, WT>;
  uint4 a[TL::A_VEC];
  uint4 b[TL::B_VEC];

  __device__ __forceinline__ void load(const Operands<T>& op, int k0) {
    constexpr int kRowChunks = TL::BK / TL::V;
#pragma unroll
    for (int j = 0; j < TL::A_VEC; ++j) {
      const int q = threadIdx.x + j * kThreads;
      const int r = q / kRowChunks, k = k0 + (q % kRowChunks) * TL::V;
      a[j] = r < op.live && k < op.d
                 ? *reinterpret_cast<const uint4*>(
                       op.x + static_cast<int64_t>(op.c0 + r) * op.d + k)
                 : make_uint4(0, 0, 0, 0);
    }
    if constexpr (WT) {         // 16 bytes along K of one column of w^T
#pragma unroll
      for (int j = 0; j < TL::B_VEC; ++j) {
        const int q = threadIdx.x + j * kThreads;
        const int n = op.n0 + q / kRowChunks;
        const int k = k0 + (q % kRowChunks) * TL::V;
        b[j] = k < op.d && n < op.f
                   ? *reinterpret_cast<const uint4*>(
                         op.w + static_cast<int64_t>(n) * op.d + k)
                   : make_uint4(0, 0, 0, 0);
      }
    } else {
      constexpr int kColChunks = kBN / TL::V;
#pragma unroll
      for (int j = 0; j < TL::B_VEC; ++j) {
        const int q = threadIdx.x + j * kThreads;
        const int k = k0 + q / kColChunks;
        const int n = op.n0 + (q % kColChunks) * TL::V;
        b[j] = k < op.d && n < op.f
                   ? *reinterpret_cast<const uint4*>(
                         op.w + static_cast<int64_t>(k) * op.f + n)
                   : make_uint4(0, 0, 0, 0);
      }
    }
  }

  __device__ __forceinline__ void store(T* as, T* bs) const {
    constexpr int kRowChunks = TL::BK / TL::V;
#pragma unroll
    for (int j = 0; j < TL::A_VEC; ++j) {
      const int q = threadIdx.x + j * kThreads;
      *reinterpret_cast<uint4*>(
          as + (q / kRowChunks) * TL::LDA + (q % kRowChunks) * TL::V) = a[j];
    }
    // B as [K, N] rows, or (WT) as [N, K] rows: column n of B is row n
    constexpr int kBRun = WT ? kRowChunks : kBN / TL::V;
#pragma unroll
    for (int j = 0; j < TL::B_VEC; ++j) {
      const int q = threadIdx.x + j * kThreads;
      *reinterpret_cast<uint4*>(
          bs + (q / kBRun) * TL::LDB + (q % kBRun) * TL::V) = b[j];
    }
  }
};

// The products of one staged chunk.  bfloat16: warp w owns output columns
// [16w, 16w + 16) and every 16-row fragment that holds a live row.
template <int BM, bool WT>
struct Mma {
  static constexpr int FM = BM / 16;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
      acc[FM];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < FM; ++i) nvcuda::wmma::fill_fragment(acc[i], 0.f);
  }

  __device__ __forceinline__ void step(const __nv_bfloat16* as,
                                       const __nv_bfloat16* bs, int live) {
    using namespace nvcuda;
    using TL = Tile<__nv_bfloat16, BM, WT>;
    using Layout = std::conditional_t<WT, wmma::col_major, wmma::row_major>;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int kk = 0; kk < TL::BK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, Layout> fb;
      wmma::load_matrix_sync(fb, WT ? bs + warp * 16 * TL::LDB + kk
                                    : bs + kk * TL::LDB + warp * 16,
                             TL::LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        if (i * 16 < live) {  // warp-uniform: fragments past the count idle
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fa;
          wmma::load_matrix_sync(fa, as + i * 16 * TL::LDA + kk, TL::LDA);
          wmma::mma_sync(acc[i], fa, fb, acc[i]);
        }
      }
    }
  }
};

// float32: thread t owns column t % 64 and rows t / 64 + 2i, i < BM / 2.
template <int BM, bool WT>
struct Fma {
  static constexpr int R = BM / 2;
  float acc[R];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;
  }

  __device__ __forceinline__ void step(const float* as, const float* bs,
                                       int) {
    using TL = Tile<float, BM, WT>;
    const int col = threadIdx.x % kBN, r0 = threadIdx.x / kBN;
#pragma unroll 4
    for (int kk = 0; kk < TL::BK; ++kk) {
      const float b = WT ? bs[col * TL::LDB + kk] : bs[kk * TL::LDB + col];
#pragma unroll
      for (int i = 0; i < R; ++i)
        acc[i] = fmaf(as[(r0 + 2 * i) * TL::LDA + kk], b, acc[i]);
    }
  }
};

template <typename T, int BM, bool WT>
struct Math;
template <int BM, bool WT>
struct Math<__nv_bfloat16, BM, WT> { using type = Mma<BM, WT>; };
template <int BM, bool WT>
struct Math<float, BM, WT> { using type = Fma<BM, WT>; };

// (c, d, f): capacity rows, the K walked, output columns.  WT: w is [E, f,
// d] and the product is xe @ w^T (dxe: xe is dy, d is F and f is D).
template <typename T, int BM, bool WT>
__global__ void __launch_bounds__(kThreads)
group_gemm_kernel(const T* __restrict__ xe, const T* __restrict__ w,
                  const int* __restrict__ counts, float* __restrict__ out,
                  int* __restrict__ tiles, int c, int d, int f) {
  using TL = Tile<T, BM, WT>;
  __shared__ __align__(128) unsigned char smem[TL::kSmemBytes];
  const int e = blockIdx.z;
  const int c0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * kBN;
  const int cnt = min(max(counts[e], 0), c);
  float* o = out + static_cast<int64_t>(e) * c * f;
  const int rows = min(BM, c - c0);
  const int cols = min(kBN, f - n0);
  if (tiles != nullptr && threadIdx.x == 0) {
    atomicAdd(tiles, 1);
    if (c0 >= cnt) atomicAdd(tiles + 1, 1);
  }
  if (c0 >= cnt) {  // skipped tile: zeros, and nothing of xe or w is read
    for (int i = threadIdx.x; i < rows * kBN; i += kThreads) {
      const int r = i / kBN, n = i % kBN;
      if (n < cols) o[static_cast<int64_t>(c0 + r) * f + n0 + n] = 0.f;
    }
    return;
  }
  const Operands<T> op{xe + static_cast<int64_t>(e) * c * d,
                       w + static_cast<int64_t>(e) * d * f, c0, n0,
                       min(BM, cnt - c0), d, f};
  T* as[2] = {reinterpret_cast<T*>(smem),
              reinterpret_cast<T*>(smem) + TL::A_ELEMS};
  T* bs[2] = {reinterpret_cast<T*>(smem) + 2 * TL::A_ELEMS,
              reinterpret_cast<T*>(smem) + 2 * TL::A_ELEMS + TL::B_ELEMS};

  typename Math<T, BM, WT>::type math;
  math.zero();
  Stage<T, BM, WT> st;
  const int nk = (d + TL::BK - 1) / TL::BK;
  if (nk > 0) st.load(op, 0);
  for (int kt = 0; kt < nk; ++kt) {
    // chunk kt into buffer kt & 1: every warp is past its products of
    // chunk kt - 2, which read that buffer, since the last barrier
    st.store(as[kt & 1], bs[kt & 1]);
    __syncthreads();
    if (kt + 1 < nk) st.load(op, (kt + 1) * TL::BK);  // in flight meanwhile
    math.step(as[kt & 1], bs[kt & 1], op.live);
  }

  if constexpr (sizeof(T) == 2) {
    // stage the float32 tile in shared memory, then write it row-guarded
    __syncthreads();  // the operand buffers become the epilogue tile
    float* cs = reinterpret_cast<float*>(smem);
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < BM / 16; ++i)
      nvcuda::wmma::store_matrix_sync(cs + i * 16 * TL::LDC + warp * 16,
                                      math.acc[i], TL::LDC,
                                      nvcuda::wmma::mem_row_major);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * kBN; i += kThreads) {
      const int r = i / kBN, n = i % kBN;
      if (n < cols)
        o[static_cast<int64_t>(c0 + r) * f + n0 + n] =
            r < op.live ? cs[r * TL::LDC + n] : 0.f;
    }
  } else {
    const int n = threadIdx.x % kBN, r0 = threadIdx.x / kBN;
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) {
      const int r = r0 + 2 * i;
      if (r < rows && n < cols)
        o[static_cast<int64_t>(c0 + r) * f + n0 + n] =
            r < op.live ? math.acc[i] : 0.f;
    }
  }
}

template <typename T, int BM, bool WT>
cudaError_t launch(const void* xe, const void* w, const int* counts,
                   float* out, int* tiles, int e, int c, int d, int f,
                   cudaStream_t stream) {
  const dim3 grid((f + kBN - 1) / kBN, (c + BM - 1) / BM, e);
  group_gemm_kernel<T, BM, WT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(xe), static_cast<const T*>(w), counts, out, tiles,
      c, d, f);
  return cudaGetLastError();
}

template <typename T, bool WT>
cudaError_t dispatch(const void* xe, const void* w, const int* counts,
                     float* out, int* tiles, int e, int c, int d, int f,
                     int bm, cudaStream_t stream) {
  if (bm == 16) return launch<T, 16, WT>(xe, w, counts, out, tiles, e, c, d,
                                         f, stream);
  if constexpr (sizeof(T) == 4) {  // bfloat16 past C 16 is the wgmma kernel's
    if (bm == 64) return launch<T, 64, WT>(xe, w, counts, out, tiles, e, c,
                                           d, f, stream);
  }
  return cudaErrorInvalidValue;
}

// out[e, r] = dy[e, r] in T for r < counts[e], else 0: 16 bytes of out a
// thread and step (8 bfloat16 from two float4, or one float4); f is a
// whole number of them, which the wrapper requires.
template <typename T>
__global__ void __launch_bounds__(256)
group_gemm_dy_kernel(const float* __restrict__ dy,
                     const int* __restrict__ counts, T* __restrict__ out,
                     int c, int f, int64_t n_vec) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const int per_row = f / V;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n_vec; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t row = i / per_row;
    const int64_t at = row * f + (i % per_row) * V;
    const int e = static_cast<int>(row / c), r = static_cast<int>(row % c);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < counts[e]) {       // counts past C act as C: r < C already
      if constexpr (sizeof(T) == 2) {
        const float4 lo = __ldcs(reinterpret_cast<const float4*>(dy + at));
        const float4 hi =
            __ldcs(reinterpret_cast<const float4*>(dy + at + 4));
        alignas(16) __nv_bfloat162 h[4] = {
            __floats2bfloat162_rn(lo.x, lo.y),
            __floats2bfloat162_rn(lo.z, lo.w),
            __floats2bfloat162_rn(hi.x, hi.y),
            __floats2bfloat162_rn(hi.z, hi.w)};
        v = *reinterpret_cast<const uint4*>(h);
      } else {
        v = __ldcs(reinterpret_cast<const uint4*>(dy + at));
      }
    }
    *reinterpret_cast<uint4*>(out + at) = v;
  }
}

}  // namespace group_gemm

// bfloat16 with C > 16: wgmma tiles of 256 rows x 128 columns
// (group_gemm_sm90.cu)
cudaError_t group_gemm_wgmma_launch(const void* xe, const void* w,
                                    const int* counts, float* out,
                                    int* tiles, int e, int c, int d, int f,
                                    cudaStream_t stream);

// Plain C++ entry point for the binding (no PyTorch headers here).  `bm`
// is the capacity rows per tile: 16 (C <= 16), 64 (float32) or 256
// (bfloat16, C > 16: the wgmma kernel); D and F are whole 16-byte rows
// and both bases 16-byte aligned; `tiles` is null or two int32 counters
// the launch adds to.  Returns the launch status.
cudaError_t group_gemm_launch(int dtype, const void* xe, const void* w,
                              const int* counts, float* out, int* tiles,
                              int e, int c, int d, int f, int bm,
                              cudaStream_t stream) {
  using namespace group_gemm;
  if (e < 0 || c < 0 || d < 0 || f < 0) return cudaErrorInvalidValue;
  if (e == 0 || c == 0 || f == 0) return cudaSuccess;
  if (e > 65535 || (c + bm - 1) / bm > 65535) return cudaErrorInvalidValue;
  if (bm == 256)
    return dtype == kBFloat16
               ? group_gemm_wgmma_launch(xe, w, counts, out, tiles, e, c, d,
                                         f, stream)
               : cudaErrorInvalidValue;
  if (dtype == kFloat32)
    return dispatch<float, false>(xe, w, counts, out, tiles, e, c, d, f, bm,
                                  stream);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16, false>(xe, w, counts, out, tiles, e, c, d,
                                          f, bm, stream);
  return cudaErrorInvalidValue;
}

// bfloat16 with C > 16: dxe on the wgmma kernel, w read as it lies
// (group_gemm_sm90.cu)
cudaError_t group_gemm_dxe_wgmma_launch(const void* dy, const void* w,
                                        const int* counts, void* dxe,
                                        int* tiles, int e, int c, int d,
                                        int f, cudaStream_t stream);

// dxe [E, C, D] = dy [E, C, F] @ w [E, D, F]^T, the rows at or past
// counts[e] zero, w read as it lies.  `bm` as for group_gemm_launch: 256
// (bfloat16, C > 16) writes dxe in bfloat16 on the wgmma kernel; 16 or 64
// write it in float32 on this file's tiles.  Returns the launch status.
cudaError_t group_gemm_dxe_launch(int dtype, const void* dy, const void* w,
                                  const int* counts, void* dxe, int* tiles,
                                  int e, int c, int d, int f, int bm,
                                  cudaStream_t stream) {
  using namespace group_gemm;
  if (e < 0 || c < 0 || d < 0 || f < 0) return cudaErrorInvalidValue;
  if (e == 0 || c == 0 || d == 0) return cudaSuccess;
  if (e > 65535 || (c + bm - 1) / bm > 65535) return cudaErrorInvalidValue;
  if (bm == 256)
    return dtype == kBFloat16
               ? group_gemm_dxe_wgmma_launch(dy, w, counts, dxe, tiles, e, c,
                                             d, f, stream)
               : cudaErrorInvalidValue;
  float* out = static_cast<float*>(dxe);
  if (dtype == kFloat32)    // K is F, the output columns D
    return dispatch<float, true>(dy, w, counts, out, tiles, e, c, f, d, bm,
                                 stream);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16, true>(dy, w, counts, out, tiles, e, c, f,
                                         d, bm, stream);
  return cudaErrorInvalidValue;
}

// out [E, C, F] (float32 or bfloat16, `dtype`) = float32 dy's rows below
// counts[e] (clamped to [0, C]), zeros past them; F a whole number of
// 16-byte runs of out, both bases 16-byte aligned.
cudaError_t group_gemm_dy_launch(int dtype, const float* dy,
                                 const int* counts, void* out, int e, int c,
                                 int f, cudaStream_t stream) {
  using namespace group_gemm;
  if (e < 0 || c < 0 || f < 0) return cudaErrorInvalidValue;
  const int v = dtype == kBFloat16 ? 8 : 4;
  if (f % v) return cudaErrorInvalidValue;
  const int64_t n_vec = static_cast<int64_t>(e) * c * (f / v);
  if (n_vec == 0) return cudaSuccess;
  const int64_t blocks = (n_vec + 255) / 256;
  const int grid = static_cast<int>(blocks < (1 << 20) ? blocks : (1 << 20));
  if (dtype == kBFloat16)
    group_gemm_dy_kernel<__nv_bfloat16><<<grid, 256, 0, stream>>>(
        dy, counts, static_cast<__nv_bfloat16*>(out), c, f, n_vec);
  else if (dtype == kFloat32)
    group_gemm_dy_kernel<float><<<grid, 256, 0, stream>>>(
        dy, counts, static_cast<float*>(out), c, f, n_vec);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
