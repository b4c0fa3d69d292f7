// The grouped expert GEMM at a join, bfloat16, for sm_90a: out[e] = xe[e]
// @ w[e] in float32 with the rows at or past counts[e] set to zero, on
// Hopper's warpgroup tensor-core products (wgmma) fed by the Tensor Memory
// Accelerator (TMA).  group_gemm.cu's launcher sends here the bfloat16
// calls whose slabs hold more than 16 rows (a join's prefill); decode (C
// 1) and float32 keep group_gemm.cu's tiles.
//
// Replaces, for those calls, the TPU kernel
// src/repro/kernels/moe_group_gemm/kernel.py (`group_gemm_kernel`, body
// `_kernel`): one grid step per (expert, 128-row tile), `pl.when` skipping
// the product of a tile past the count.
//
// What bounds it on an H100.  At a 4,096-token join of full-width moonshot
// (E 64, C 480, D 2048 -> F 1408, about 24,600 live rows in 64 live
// experts) the bytes do: every live expert's weights (369 MB), the live
// rows (101 MB) and every output row in float32 (173 MB) take 0.19 ms at
// 3.35 TB/s, against 0.14 TFLOP, 0.14 ms at the bf16 tensor-core peak.
// The operations sit just under the bytes, so the products have to run
// near the peak rate, which only wgmma reaches, and the operands have to
// come from L2 at the rate the products use them.
//
// What the design does about it.  A CTA owns 256 capacity rows x 128
// output columns of one expert and reads counts[e] first: a tile whose
// first row is at or past the count writes its zeros and issues no copy.
// A live tile has one producer warp and four consumer warpgroups of 64
// rows each; a warpgroup whose rows are all past the count loads nothing
// and issues no product.  The producer keeps a ring of four K stages (64
// bf16 of K each) filled by TMA from 3-D tensor maps over xe (D, C, E) and
// w (F, D, E), in the 128-byte swizzle that wgmma reads without bank
// conflicts; the boxes' out-of-bounds fill gives the ragged C, D and F
// edges as zeros.  Each stage has a full barrier (its bytes have arrived)
// and an empty one (every working warp is done with it).  The consumers
// run wgmma m64n128k16 with A (xe, K-major) and B (w, N-major: the
// transpose bit) from shared memory into float32 registers, keep one
// stage's products in flight while they release the one before, and write
// the tile from registers, choosing 0 (never multiplying by a mask:
// padding rows may hold NaN) for the rows past the count.  The grid's
// fastest index is the row tile, so the CTAs that share an expert's weight
// columns run side by side and read them from L2.
//
// Why this tile.  A stage of a 128 x 128 tile (two CTAs an SM) brings 32 KB
// from L2 for 2.1 MFLOP, and L2 cannot feed that at the products' rate: at
// the join such a kernel spent about as long on its loads alone as in all.
// The 256 x 128 tile brings 48 KB for 4.2 MFLOP; it needs one CTA an SM
// (192 KB of ring), so a tile's epilogue, 128 KB of float32, no longer
// overlaps another CTA's products, and that epilogue is now the largest
// cost above the products.  Wider tiles (192 x 192, 128 x 256), TMA
// multicast across clusters of CTAs, TMA stores for the epilogue and
// walking several column tiles a CTA were no faster at the join.  A
// persistent schedule over the live tiles, which would overlap the
// epilogue with the next tile's products, and a fused gate-and-up product
// are later work.
//
// The tensor maps are made on the host per call with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (nothing
// links the driver library), and passed as __grid_constant__ parameters.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace group_gemm_sm90 {

constexpr int kConsumers = 4;               // warpgroups of 64 rows
constexpr int kBM = 64 * kConsumers;        // capacity rows per CTA
constexpr int kBN = 128;                    // output columns per CTA
constexpr int kBK = 64;                     // K per stage: 128 bytes of bf16
constexpr int kStages = 4;
constexpr int kThreads = kConsumers * 128 + 32;   // and one producer warp
constexpr int kASlice = 64 * kBK * 2;       // one warpgroup's rows, 8 KB
constexpr int kBoxBytes = kBK * 64 * 2;     // 64 columns of w, 8 KB
constexpr int kStageBytes = kConsumers * kASlice + 2 * kBoxBytes;
constexpr int kSmemBytes = 1024             // room to align the ring
                           + kStages * kStageBytes + 2 * kStages * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One box of a 3-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int x, int y,
                                            int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x),
         "r"(y), "r"(z)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

// d[64 rows of the warpgroup, 128 columns] += A (K-major) * B (N-major)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Shared memory, from a 1024-byte aligned base: kStages x {A: kBM rows x
// 128 bytes, one 64-row slice per consumer warpgroup; B: two boxes of 64 K
// rows x 128 bytes (columns n0..n0+63, then n0+64..n0+127)}, then the full
// and the empty barriers.  The grid is (row tiles, column tiles, E).
__global__ void __launch_bounds__(kThreads, 1)
group_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap,
                        const int* __restrict__ counts,
                        float* __restrict__ out, int* __restrict__ tiles,
                        int c, int d, int f) {
  extern __shared__ unsigned char smem_raw[];
  const int c0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN, e = blockIdx.z;
  const int cnt = min(max(counts[e], 0), c);
  float* o = out + static_cast<int64_t>(e) * c * f;
  if (tiles != nullptr && threadIdx.x == 0) {
    atomicAdd(tiles, 1);
    if (c0 >= cnt) atomicAdd(tiles + 1, 1);
  }
  if (c0 >= cnt) {  // skipped tile: zeros, and nothing of xe or w is read
    const int rows = min(kBM, c - c0), cols = min(kBN, f - n0);
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = threadIdx.x; i < rows * (kBN / 4); i += kThreads) {
      const int r = i / (kBN / 4), n = (i % (kBN / 4)) * 4;
      if (n < cols)   // F is a multiple of 8, so a float4 is whole
        *reinterpret_cast<float4*>(
            o + static_cast<int64_t>(c0 + r) * f + n0 + n) = z;
    }
    return;
  }
  // warpgroups with a live row: they alone load their rows and multiply
  const int n_wg = (min(kBM, cnt - c0) + 63) / 64;
  const int nk = (d + kBK - 1) / kBK;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t bars = ring + kStages * kStageBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), n_wg * 4);    // one arrive per working warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == kConsumers * 4) {               // the producer warp
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages, phase = (kt / kStages) & 1;
        mbar_wait(empty(s), phase ^ 1);       // the first round passes
        mbar_expect_tx(full(s), n_wg * kASlice + 2 * kBoxBytes);
        const uint32_t a = ring + s * kStageBytes;
        const uint32_t b = a + kConsumers * kASlice;
        for (int g = 0; g < n_wg; ++g)
          tma_load_3d(a + g * kASlice, &xmap, full(s), kt * kBK, c0 + 64 * g,
                      e);
        tma_load_3d(b, &wmap, full(s), n0, kt * kBK, e);
        tma_load_3d(b + kBoxBytes, &wmap, full(s), n0 + 64, kt * kBK, e);
      }
    }
    return;
  }

  const int wg = warp >> 2;                   // consumer warpgroup
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  if (wg < n_wg) {
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kStages, phase = (kt / kStages) & 1;
      mbar_wait(full(s), phase);
      const uint32_t a = ring + s * kStageBytes + wg * kASlice;
      const uint32_t b = ring + s * kStageBytes + kConsumers * kASlice;
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        // A: 32 bytes of K a step inside the 128-byte rows; 8-row groups
        // 1024 bytes apart.  B: 16 K rows (2,048 bytes) a step; 8-row
        // groups 1024 bytes apart, the second 64 columns a box further.
        wgmma_m64n128k16(acc, smem_desc(a + kk * 32, 16, 1024),
                         smem_desc(b + kk * 2048, kBoxBytes, 1024));
      wgmma_commit();
      wgmma_wait<1>();                        // stage kt - 1 is read
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
      if (kt > 0 && lane == 0) mbar_arrive(empty((kt - 1) % kStages));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
  }

  // epilogue: thread (warp w of the warpgroup, lane 4 gid + t4) holds rows
  // 16 w + gid and + 8, columns 8 j + 2 t4 and + 1 of each 8-column block j
  const int gid = lane >> 2, t4 = lane & 3;
  const int ra = c0 + wg * 64 + (warp & 3) * 16 + gid, rb = ra + 8;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * t4;
    if (n < f) {                              // F even: n + 1 < F too
      if (ra < c)
        *reinterpret_cast<float2*>(o + static_cast<int64_t>(ra) * f + n) =
            ra < cnt ? make_float2(acc[4 * j], acc[4 * j + 1])
                     : make_float2(0.f, 0.f);
      if (rb < c)
        *reinterpret_cast<float2*>(o + static_cast<int64_t>(rb) * f + n) =
            rb < cnt ? make_float2(acc[4 * j + 2], acc[4 * j + 3])
                     : make_float2(0.f, 0.f);
    }
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 [outer, mid, inner] array as a 3-D map of boxes {64, box_mid, 1}
// in the 128-byte swizzle; elements outside the array read as zeros.
bool make_map(CUtensorMap* map, const void* base, int64_t inner,
              int64_t mid, int64_t outer, int box_mid) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(mid),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(inner) * 2,
                                 static_cast<cuuint64_t>(inner * mid) * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_mid), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace group_gemm_sm90

// Entry point for group_gemm.cu's launcher: xe [E, C, D] and w [E, D, F]
// bf16 with rows of whole 16 bytes on 16-byte aligned bases, counts [E]
// int32, out [E, C, F] float32; `tiles` is null or two int32 counters the
// launch adds to.  Returns the launch status.
cudaError_t group_gemm_wgmma_launch(const void* xe, const void* w,
                                    const int* counts, float* out,
                                    int* tiles, int e, int c, int d, int f,
                                    cudaStream_t stream) {
  using namespace group_gemm_sm90;
  CUtensorMap xmap, wmap;
  if (!make_map(&xmap, xe, d, c, e, 64) || !make_map(&wmap, w, f, d, e, 64))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      group_gemm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((c + kBM - 1) / kBM, (f + kBN - 1) / kBN, e);
  group_gemm_wgmma_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      xmap, wmap, counts, out, tiles, c, d, f);
  return cudaGetLastError();
}
