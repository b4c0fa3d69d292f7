// Sparsity-aware skinny GEMM in bfloat16 on the tensor cores, for sm_90a:
// C[M, N] float32 = the sum over the walked k-blocks of A[:, blk] @ B[blk],
// N 1-16, with the products as mma.sync m16n8k16 (bf16 in, float32
// accumulators).  The same function and the same two walks (walk.cuh) as
// the CUDA-core walk of ss_gemm.cu; the wrapper (kernel.py, `route`) sends
// here the bfloat16 calls whose rows of A are whole 16 bytes (K % 8 == 0),
// whose A and B start on 16-byte boundaries and whose bk is a multiple of
// 16.  Replaces, for those calls, `ssgemm_masked_kernel` and
// `ssgemm_compact_kernel` of src/repro/kernels/ss_gemm/kernel.py.
//
// What bounds it on an H100: device-memory bytes.  A live k-block of A is
// read once (128 MiB at the paper's M 16,384 x K 4,096) for 2 x N flops an
// element: at most 16 flops a byte at N 16, against the ~295 at which the
// bf16 tensor cores would set the pace.  So the products only have to stay
// off the critical path, and the work is to keep enough of A in flight to
// stream it at the card's rate: 3.35 TB/s at about a microsecond of
// latency needs some 25 KB in flight on each of 132 SMs.
//
// What the design does about it.  A CTA of eight warps owns 64 rows of M,
// so M 16,384 is 256 CTAs, two an SM.  It walks the live k-blocks in stages
// of 128 columns: a stage is 64 rows x 256 bytes of A and the same 128 rows
// of B, copied by 16-byte cp.async into a four-stage ring in shared memory,
// so three stages (96 KB an SM) are in flight while one is multiplied.  A
// thread's copies of A are four chunks of one column, 16 rows apart, whose
// addresses are set up once; a stage only adds its first column.  A stage
// never reaches past its block: columns past the block's end, rows past M
// and rows of B past K are zero-filled, not read, so a skipped block issues
// no load of A or B.  B's rows of a stage are contiguous in memory (128 x N
// values), so they are copied raw whatever N is.  Four warps take the four
// 16-row tiles and the first half of each stage's k16 steps, the other four
// the second half, and add their sums into the first four's once, through
// shared memory, at the end.  A's fragments come from the ring by ldmatrix
// (rows padded by 16 bytes, so the eight rows of a matrix hit 32 banks);
// B's by one ldmatrix.trans a k16 step where N is 8 or 16, else each lane
// gathers its pairs, with zeros for the columns at or past N.  bf16 x bf16
// products are exact in float32 and the sums stay in float32 registers over
// the whole walk; each lane stores its C fragments once, columns below N
// only, with no shuffle.  A walk is compacted into a list in shared memory,
// 256 steps at a time (one mask entry or list id a thread), so the ring's
// producer finds the next live block without a dependent load of device
// memory.  On the card this ring streams A about as fast as plain 16-byte
// loads of the same rows do; a producer warp feeding the ring (cp.async or
// TMA, with mbarriers), deeper or wider stages, 128-row CTAs and a rotated
// walk order were no faster.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "walk.cuh"

namespace ss_gemm_tc {

using ss_gemm::ListWalk;
using ss_gemm::MaskWalk;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;              // rows of A a CTA owns
constexpr int kCols = 128;             // columns of A a stage holds
constexpr int kStages = 4;             // ring depth
constexpr int kLda = kCols + 8;        // padded row of a stage, in elements
constexpr int kMTiles = kRows / 16;    // 16-row tiles of the product
constexpr int kSplit = kWarps / kMTiles;          // warps sharing a tile
constexpr int kKSteps = kCols / 16 / kSplit;      // k16 steps a warp takes
static_assert(kWarps % kMTiles == 0 && kCols / 16 % kSplit == 0,
              "a stage's k16 steps split evenly over the warps of a tile");
constexpr int kWindow = kThreads;      // walk steps compacted at a time
constexpr int kMaxWidth = 16;
constexpr int kStageA = kRows * kLda;          // elements
constexpr int kStageB = kCols * kMaxWidth;     // elements
constexpr int kSmemBytes = kStages * (kStageA + kStageB) * 2
                           + kWindow * 4 + kWarps * 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, with a 256-byte L2 prefetch hint; src_bytes 0
// writes 16 zero bytes and reads none
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
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
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, "
               "[%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
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

// A position in the compacted walk: entry `li` of the list, column `off`
// of that block.  A stage starts at column c0 = list[li] * bk + off and
// holds len = min(kCols, the block's end - c0) columns (a multiple of 8).
struct Cursor {
  int li = 0, off = 0;
  __device__ __forceinline__ bool more(int n_list) const {
    return li < n_list;
  }
  __device__ __forceinline__ void stage(const int* list, int bk, int k,
                                        int& c0, int& len) const {
    const int kb0 = list[li] * bk;
    c0 = kb0 + off;
    len = min(kCols, min(bk, k - kb0) - off);
  }
  __device__ __forceinline__ void advance(const int* list, int bk, int k) {
    const int kb0 = list[li] * bk;
    off += kCols;
    if (off >= min(bk, k - kb0)) {
      ++li;
      off = 0;
    }
  }
};

// A thread's share of a stage's copies of A: kPer 16-byte chunks, one
// column of chunks, rows kStep apart.  Fixed for the whole walk, so a stage
// only adds its first column.
constexpr int kChunks = kCols / 8;                 // 16-byte chunks a row
constexpr int kPer = kRows * kChunks / kThreads;   // chunks a thread
constexpr int kStep = kThreads / kChunks;          // rows between them
static_assert(kThreads % kChunks == 0 && kRows % kStep == 0,
              "whole chunks a thread");

struct Copier {
  const bf16* src;  // the first chunk's row, at column `col`
  uint32_t dst;     // the first chunk's byte offset in a stage
  int col;          // the chunks' column in a stage
  int rows;         // how many of the kPer rows lie below M
  int64_t stride;   // elements between the rows of two chunks
};

__device__ __forceinline__ Copier make_copier(const bf16* a, int m, int k,
                                              int64_t row0) {
  const int r = threadIdx.x / kChunks, c = threadIdx.x % kChunks;
  const int64_t left = m - (row0 + r);
  return {a + (row0 + r) * k + c * 8,
          static_cast<uint32_t>((r * kLda + c * 8) * 2), c * 8,
          static_cast<int>(left <= 0 ? 0 : (left + kStep - 1) / kStep),
          static_cast<int64_t>(kStep) * k};
}

// Copies one stage: rows [row0, row0 + kRows) x columns [c0, c0 + len) of
// A and rows [c0, c0 + len) of B (len * n values, contiguous); the rest of
// the stage is zero-filled, and nothing past it is read.
__device__ __forceinline__ void issue_stage(const Copier& cp,
                                            const bf16* __restrict__ b,
                                            int n, int c0, int len,
                                            uint32_t a_s, uint32_t b_s) {
  const bf16* src = cp.src + c0;
#pragma unroll
  for (int it = 0; it < kPer; ++it) {
    const bool ok = it < cp.rows && cp.col < len;
    cp_async16(a_s + cp.dst + it * kStep * kLda * 2,
               ok ? src + it * cp.stride : b, ok ? 16 : 0);  // b: read 0 B
  }
  const int chunks = kCols * n / 8, valid = len * n / 8;
  for (int q = threadIdx.x; q < chunks; q += kThreads) {
    const bool ok = q < valid;
    cp_async16(b_s + q * 16,
               ok ? b + static_cast<int64_t>(c0) * n + q * 8 : b, ok ? 16 : 0);
  }
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 gid + t4.  A (16x16)
// from ldmatrix.x4 of the warp's 16 rows; B (16x8) b0 = (2t4..+1, gid), b1 =
// (2t4 + 8..+9, gid); C (16x8) c0, c1 = (gid, 2t4..+1), c2, c3 = (gid + 8,
// 2t4..+1).  NT n8 tiles: 1 for N <= 8, 2 for N <= 16.  WHOLE: N == 8 NT,
// so a stage's rows of B are 16 or 32 bytes and ldmatrix.trans reads the B
// fragments of a k16 step in one instruction; otherwise each lane gathers
// its four pairs and zero-pads the columns at or past N.
template <int NT, bool WHOLE, typename Walk>
__global__ void __launch_bounds__(kThreads)
ssgemm_tc_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                 float* __restrict__ out, int m, int k, int n, int bk,
                 Walk walk) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* a_ring = reinterpret_cast<bf16*>(smem);  // [kStages][kRows][kLda]
  bf16* b_ring = a_ring + kStages * kStageA;     // [kStages][kCols][n]
  int* list = reinterpret_cast<int*>(b_ring + kStages * kStageB);
  int* warp_live = list + kWindow;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, t4 = lane & 3;
  const int mt = warp % kMTiles, kq = warp / kMTiles;  // tile, k share
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const uint32_t a_base = smem_u32(a_ring), b_base = smem_u32(b_ring);
  const Copier copier = make_copier(a, m, k, row0);
  // this lane's ldmatrix row and column inside a stage
  const uint32_t a_frag = ((mt * 16 + (lane & 15)) * kLda + (lane >> 4) * 8
                           + kq * kKSteps * 16) * 2;
  // and its ldmatrix.trans row of a stage's B (WHOLE): matrices (k 0-7,
  // n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
  const uint32_t b_frag =
      ((kq * kKSteps * 16 + (lane & 15)) * 8 * NT + (lane >> 4) * 8 * (NT - 1))
      * 2;

  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;

  const int steps = walk.steps();
  for (int j0 = 0; j0 < steps; j0 += kWindow) {
    // compact this window of the walk into `list`, in walk order
    const int j = j0 + static_cast<int>(threadIdx.x);
    const int kb = j < steps ? walk.block(j) : -1;
    const unsigned live = __ballot_sync(0xffffffffu, kb >= 0);
    if (lane == 0) warp_live[warp] = __popc(live);
    __syncthreads();
    int base = 0, n_list = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      base += w < warp ? warp_live[w] : 0;
      n_list += warp_live[w];
    }
    if (kb >= 0) list[base + __popc(live & ((1u << lane) - 1))] = kb;
    __syncthreads();

    Cursor prod, cons;
    int issued = 0;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (prod.more(n_list)) {
        int c0, len;
        prod.stage(list, bk, k, c0, len);
        issue_stage(copier, b, n, c0, len, a_base + s * kStageA * 2,
                    b_base + s * kStageB * 2);
        prod.advance(list, bk, k);
        ++issued;
      }
      cp_async_commit();
    }
    for (int i = 0; i < issued; ++i) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // stage i has landed; stage i - 1 has been read
      if (prod.more(n_list)) {
        const int s = (i + kStages - 1) % kStages;
        int c0, len;
        prod.stage(list, bk, k, c0, len);
        issue_stage(copier, b, n, c0, len, a_base + s * kStageA * 2,
                    b_base + s * kStageB * 2);
        prod.advance(list, bk, k);
        ++issued;
      }
      cp_async_commit();

      const int s = i % kStages;
      int c0, len;
      cons.stage(list, bk, k, c0, len);
      cons.advance(list, bk, k);
      const uint32_t a_s = a_base + s * kStageA * 2 + a_frag;
      const uint32_t b_sw = b_base + s * kStageB * 2 + b_frag;
      const uint16_t* b_s =
          reinterpret_cast<const uint16_t*>(b_ring + s * kStageB);
#pragma unroll
      for (int u = 0; u < kKSteps; ++u) {
        const int ks = kq * kKSteps + u;
        if (ks * 16 < len) {
          uint32_t af[4], bf[4];
          ldmatrix_x4(af, a_s + u * 32);
          if constexpr (WHOLE) {
            if constexpr (NT == 2)
              ldmatrix_x4_trans(bf, b_sw + u * 16 * 8 * NT * 2);
            else
              ldmatrix_x2_trans(bf, b_sw + u * 16 * 8 * NT * 2);
          } else {
#pragma unroll
            for (int t = 0; t < NT; ++t) {
              const int col = t * 8 + gid;
              bf[2 * t] = bf[2 * t + 1] = 0;
              if (col < n) {
                const uint16_t* p = b_s + (ks * 16 + 2 * t4) * n + col;
                bf[2 * t] = p[0] | static_cast<uint32_t>(p[n]) << 16;
                bf[2 * t + 1] =
                    p[8 * n] | static_cast<uint32_t>(p[9 * n]) << 16;
              }
            }
          }
#pragma unroll
          for (int t = 0; t < NT; ++t)
            mma16816(acc[t], af, bf[2 * t], bf[2 * t + 1]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring and the list are free for the next window
  }

  if constexpr (kSplit > 1) {  // warps kq > 0 add their sums to warp kq 0's
    float* red = reinterpret_cast<float*>(smem);  // the ring is free now
    float* mine = red + ((kq * kMTiles + mt) * 32 + lane) * NT * 4;
    if (kq > 0)
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[t * 4 + e] = acc[t][e];
    __syncthreads();
    if (kq > 0) return;
    for (int q = 1; q < kSplit; ++q)
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[t][e] += mine[q * kMTiles * 32 * NT * 4 + t * 4 + e];
  }
  const int64_t r_lo = row0 + mt * 16 + gid, r_hi = r_lo + 8;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int col = t * 8 + 2 * t4;
    if (n % 2 == 0) {  // (col, col + 1) in one 8-byte store
      if (col >= n) continue;
      if (r_lo < m)
        *reinterpret_cast<float2*>(out + r_lo * n + col) =
            make_float2(acc[t][0], acc[t][1]);
      if (r_hi < m)
        *reinterpret_cast<float2*>(out + r_hi * n + col) =
            make_float2(acc[t][2], acc[t][3]);
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (col + e >= n) continue;
        if (r_lo < m) out[r_lo * n + col + e] = acc[t][e];
        if (r_hi < m) out[r_hi * n + col + e] = acc[t][2 + e];
      }
    }
  }
}

template <typename Walk>
cudaError_t launch(const void* a, const void* b, float* out, int m, int k,
                   int n, int bk, Walk walk, cudaStream_t stream) {
  if (m < 0 || k < 8 || k % 8 != 0 || n < 1 || n > kMaxWidth || bk < 16 ||
      bk % 16 != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0)
    return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const dim3 grid((m + kRows - 1) / kRows);
  const bf16* at = static_cast<const bf16*>(a);
  const bf16* bt = static_cast<const bf16*>(b);
  auto kernel = n == 16 ? ssgemm_tc_kernel<2, true, Walk>
                : n == 8 ? ssgemm_tc_kernel<1, true, Walk>
                : n < 8  ? ssgemm_tc_kernel<1, false, Walk>
                         : ssgemm_tc_kernel<2, false, Walk>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(at, bt, out, m, k, n, bk,
                                                 walk);
  return cudaGetLastError();
}

}  // namespace ss_gemm_tc

// Plain C++ entry points for the binding (no PyTorch headers here).  Each
// returns the launch status.  a [M, K] and b [K, N] (N <= 16) bfloat16 on
// 16-byte aligned bases, K % 8 == 0, bk % 16 == 0; out [M, N] float32;
// nk = ceil(K / bk) k-blocks.
cudaError_t ssgemm_masked_tc_launch(const void* a, const void* b,
                                    const int* mask, float* out, int m, int k,
                                    int n, int bk, cudaStream_t stream) {
  using namespace ss_gemm_tc;
  const int nk = bk > 0 ? (k + bk - 1) / bk : 0;
  return launch(a, b, out, m, k, n, bk, MaskWalk{mask, nk}, stream);
}

cudaError_t ssgemm_compact_tc_launch(const void* a, const void* b,
                                     const int* idx, const int* n_live,
                                     int budget, float* out, int m, int k,
                                     int n, int bk, cudaStream_t stream) {
  using namespace ss_gemm_tc;
  if (budget < 1) return cudaErrorInvalidValue;
  const int nk = bk > 0 ? (k + bk - 1) / bk : 0;
  return launch(a, b, out, m, k, n, bk, ListWalk{idx, n_live, budget, nk},
                stream);
}
