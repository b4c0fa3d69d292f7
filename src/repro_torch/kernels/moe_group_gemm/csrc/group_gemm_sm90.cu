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
// The backward, for the same calls (bfloat16, C > 16), has two more
// kernels here; the training step runs them (ops.group_gemm_backward).
// JAX differentiates the einsum outside any Pallas kernel, so they replace
// no TPU kernel of their own: they are this kernel's backward.
//
// dxe[e] = dy[e] @ w[e]^T is this kernel with one template flag flipped
// (group_gemm_wgmma_kernel<true>): A is dy ([E, C, F], K = F), mapped and
// described as the forward's xe; B is w read as it lies ([E, D, F], K = F
// contiguous), two boxes of 64 rows of w by 64 K, with the K-major
// descriptor the forward gives A and the transpose bit off.  No copy of w
// is made.  It writes dxe in bfloat16, the rows past the count chosen as
// 0, through shared memory (the ring, once every warpgroup is done with
// it) and TMA stores, as dw below.  At moonshot's join it reads the live
// experts' w (369 MB) and writes dxe (126 MB): about 0.15 ms of bytes
// against 0.14 ms of products, the same balance as the forward.
//
// dw[e] = xe[e]^T @ dy[e] (group_gemm_dw_kernel) runs M = D, N = F and
// K = the expert's live rows: A is xe read M-major (boxes of 64 columns
// of D by 64 rows of C, the descriptor form of the forward's B, transpose
// bit on), B is dy read N-major exactly as the forward reads w.  The K
// loop stops after ceil(count / 64) stages; in the last one the rows at
// or past the count (each one whole 128-byte swizzled line of a box) are
// zeroed by the consumers, then fenced (fence.proxy.async) before wgmma
// reads them: xe may hold NaN there, and 0 x NaN is NaN.  An expert with
// count 0 writes zeros and loads nothing.  K is short (6 stages at
// moonshot's join, 3 at deepseek's) and the write of dw is the largest
// cost (369 MB in bf16 at moonshot, 7.5 GB at deepseek, 2.2 ms of bytes
// there alone), so a CTA of dw is persistent: one a SM walks the tiles in
// turn, and its producer warp loads the next tile's stages while the
// consumers write the last tile out.  They write it through shared memory
// and TMA stores, whole 128-byte lines: storing the registers' 4-byte
// bf16 pairs straight to memory, as the forward stores its float32
// pairs, wrote dw at about 600 GB/s on an H100 (0.63 ms at moonshot's
// join, 12.2 ms at deepseek's).
//
// The tensor maps are made on the host per call with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (nothing
// links the driver library), and passed as __grid_constant__ parameters.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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
// dw: a ring of 3 stages, then one warpgroup's 64 x 128 bf16 tile a
// consumer warpgroup, staged for its TMA store (two boxes of 64 columns)
constexpr int kDwStages = 3;
constexpr int kOutSlice = 64 * kBN * 2;     // 16 KB
constexpr int kDwSmemBytes = 1024 + kDwStages * kStageBytes +
                             kConsumers * kOutSlice + 2 * kDwStages * 8;

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

// d[64 rows of the warpgroup, 128 columns] += A * B; kTransA and kTransB
// name each operand's layout in shared memory: 0 K-major, 1 M- or N-major.
template <int kTransA, int kTransB>
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
      " %64, %65, p, 1, 1, %67, %68;\n"
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
      : "l"(da), "l"(db), "r"(1), "n"(kTransA), "n"(kTransB));
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

// One box of a 3-D tensor map from shared memory to global memory (the
// parts past the map's bounds are not written), in the thread's bulk group.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int x, int y,
                                             int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(x), "r"(y),
         "r"(z)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// The thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// The thread's bulk stores are done.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Named barrier 2 + wg over the 128 threads of consumer warpgroup wg.
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");
}

__device__ __forceinline__ void st_shared_zero16(uint32_t addr) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n"
               :: "r"(addr), "r"(0) : "memory");
}
// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Named barrier 1 over the consumer warpgroups (the producer warp is out).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers * 128) : "memory");
}


// Zeros on rows [r0, r0 + rows) x columns [n0, n0 + min(cols, kBN)) of a
// row-major matrix `ld` wide, 16 bytes a store (ld and cols are whole
// 16-byte runs, which the wrappers require), by threads tid of nthreads.
template <typename T>
__device__ __forceinline__ void zero_block(T* o, int64_t ld, int r0,
                                           int rows, int n0, int cols,
                                           int tid, int nthreads) {
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  constexpr int kRun = kBN / kV;
  for (int i = tid; i < rows * kRun; i += nthreads) {
    const int r = i / kRun, n = (i % kRun) * kV;
    if (n < cols)
      *reinterpret_cast<uint4*>(o + (r0 + r) * ld + n0 + n) =
          make_uint4(0, 0, 0, 0);
  }
}

// One warpgroup's 64 x 128 products from registers to o (row-major
// float32, ld wide), rows from r_wg: rows below `live` take the products,
// rows from `live` up to `rows` take 0 (chosen, never multiplied: padding
// rows may hold NaN), rows past `rows` and columns past `cols` are not
// written.  Thread (warp w of the warpgroup, lane 4 gid + t4) holds rows
// 16 w + gid and + 8, columns 8 j + 2 t4 and + 1 of each 8-column block j.
__device__ __forceinline__ void store_tile(const float (&acc)[64], float* o,
                                           int64_t ld, int r_wg, int rows,
                                           int live, int n0, int cols) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int gid = lane >> 2, t4 = lane & 3;
  const int ra = r_wg + warp * 16 + gid, rb = ra + 8;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * t4;
    if (n < cols) {                           // cols even: n + 1 < cols too
      if (ra < rows)
        *reinterpret_cast<float2*>(o + ra * ld + n) =
            ra < live ? make_float2(acc[4 * j], acc[4 * j + 1])
                      : make_float2(0.f, 0.f);
      if (rb < rows)
        *reinterpret_cast<float2*>(o + rb * ld + n) =
            rb < live ? make_float2(acc[4 * j + 2], acc[4 * j + 3])
                      : make_float2(0.f, 0.f);
    }
  }
}

// One warpgroup's 64 x 128 products in bf16, rows from `live` (counted
// from the warpgroup's first row) chosen as 0, through its 16 KB staging
// `slice` to memory: two boxes of 64 columns in the 128-byte swizzle (no
// bank conflicts), stored with TMA at (x0, y0, z) of `map`, which writes
// nothing past its bounds.  The slice's previous store must have read it
// first; the caller waits for the last one (bulk_wait) before it exits.
__device__ __forceinline__ void store_tile_tma(const float (&acc)[64],
                                               uint32_t slice,
                                               const CUtensorMap* map, int wg,
                                               int x0, int y0, int z,
                                               int live) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int gid = lane >> 2, t4 = lane & 3, r = warp * 16 + gid;
  const bool leader = (threadIdx.x & 127) == 0;
  if (leader) bulk_wait_read();
  warpgroup_sync(wg);
  // thread (warp w, lane 4 gid + t4) holds rows 16 w + gid and + 8,
  // columns 8 j + 2 t4 and + 1: chunk j % 8 of box j / 8, swizzled
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const uint32_t at = slice + (j / 8) * kBoxBytes + r * 128 +
                        (((j % 8) ^ gid) << 4) + t4 * 4;
    __nv_bfloat162 lo = __floats2bfloat162_rn(r < live ? acc[4 * j] : 0.f,
                                              r < live ? acc[4 * j + 1] : 0.f);
    __nv_bfloat162 hi = __floats2bfloat162_rn(
        r + 8 < live ? acc[4 * j + 2] : 0.f,
        r + 8 < live ? acc[4 * j + 3] : 0.f);
    asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(at),
                 "r"(*reinterpret_cast<uint32_t*>(&lo)) : "memory");
    asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(at + 8 * 128),
                 "r"(*reinterpret_cast<uint32_t*>(&hi)) : "memory");
  }
  fence_proxy_async();
  warpgroup_sync(wg);
  if (leader) {
    tma_store_3d(map, slice, x0, y0, z);
    tma_store_3d(map, slice + kBoxBytes, x0 + 64, y0, z);
    bulk_commit();
  }
}

// Shared memory, from a 1024-byte aligned base: kStages x {A: kBM rows x
// 128 bytes, one 64-row slice per consumer warpgroup; B: two boxes of 64
// rows x 128 bytes}, then the full and the empty barriers.  The grid is
// (row tiles, column tiles, E).  (c, k, n) are the capacity rows, the K
// walked and the output columns.
//   kDxe false, the forward: out [E, C, N] float32 = a @ b, a = xe [E, C,
//     K] (K-major), b = w [E, K, N] (boxes of 64 K rows x 64 columns:
//     N-major, the transpose bit on).
//   kDxe true, dxe: out [E, C, N] bfloat16 = a @ b^T, a = dy [E, C, K],
//     b = w [E, N, K] as it lies (boxes of 64 rows of w x 64 K: K-major,
//     the transpose bit off).  Its live tiles are written through `omap`
//     (N, C, E) with TMA stores, the ring turned staging once every
//     warpgroup is done with it (store_tile_tma); the forward's go
//     straight from the registers.
template <bool kDxe>
__global__ void __launch_bounds__(kThreads, 1)
group_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                        const __grid_constant__ CUtensorMap bmap,
                        const __grid_constant__ CUtensorMap omap,
                        const int* __restrict__ counts,
                        void* __restrict__ out_raw, int* __restrict__ tiles,
                        int c, int k, int n) {
  using OutT = std::conditional_t<kDxe, __nv_bfloat16, float>;
  extern __shared__ unsigned char smem_raw[];
  const int c0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN, e = blockIdx.z;
  const int cnt = min(max(counts[e], 0), c);
  OutT* o = static_cast<OutT*>(out_raw) + static_cast<int64_t>(e) * c * n;
  if (tiles != nullptr && threadIdx.x == 0) {
    atomicAdd(tiles, 1);
    if (c0 >= cnt) atomicAdd(tiles + 1, 1);
  }
  if (c0 >= cnt) {  // skipped tile: zeros, and nothing of a or b is read
    zero_block(o, n, c0, min(kBM, c - c0), n0, n - n0, threadIdx.x,
               kThreads);
    return;
  }
  // warpgroups with a live row: they alone load their rows and multiply
  const int n_wg = (min(kBM, cnt - c0) + 63) / 64;
  const int nk = (k + kBK - 1) / kBK;
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
          tma_load_3d(a + g * kASlice, &amap, full(s), kt * kBK, c0 + 64 * g,
                      e);
        for (int h = 0; h < 2; ++h) {
          if constexpr (kDxe)   // rows n0 + 64 h.. of w, 64 K each
            tma_load_3d(b + h * kBoxBytes, &bmap, full(s), kt * kBK,
                        n0 + 64 * h, e);
          else                  // K rows kt * kBK.., columns n0 + 64 h..
            tma_load_3d(b + h * kBoxBytes, &bmap, full(s), n0 + 64 * h,
                        kt * kBK, e);
        }
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
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // A: 32 bytes of K a step inside the 128-byte rows; 8-row groups
        // 1024 bytes apart.  B, N-major: 16 K rows (2,048 bytes) a step;
        // 8-row groups 1024 bytes apart, the second 64 columns a box
        // further.  B, K-major: as A, its 128 rows of w in two boxes one
        // after the other.
        const uint64_t da = smem_desc(a + kk * 32, 16, 1024);
        if constexpr (kDxe)
          wgmma_m64n128k16<0, 0>(acc, da, smem_desc(b + kk * 32, 16, 1024));
        else
          wgmma_m64n128k16<0, 1>(acc, da,
                                 smem_desc(b + kk * 2048, kBoxBytes, 1024));
      }
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
  if constexpr (kDxe) {
    consumers_sync();     // every load has landed and every product read
    store_tile_tma(acc, ring + wg * kOutSlice, &omap, wg, n0, c0 + wg * 64,
                   e, cnt - c0 - wg * 64);
    if ((threadIdx.x & 127) == 0) bulk_wait();
  } else {
    store_tile(acc, o, n, c0 + wg * 64, c, cnt, n0, n);
  }
}

// dw[e] = xe[e]^T @ dy[e] over the rows below counts[e]: xe [E, C, D],
// dy [E, C, F] bfloat16, dw [E, D, F] bfloat16 (float32 sums), written
// through `omap` (F, D, E).  A tile is
// kBM rows of D x kBN columns of F of one expert; tile t is (t mod the
// row tiles, then the column tiles, then the expert), and CTA b walks
// tiles b, b + gridDim.x, ...  The ring's stages run on across tiles: the
// producer loads the next tile while the consumers write the last one.
// A stage holds, per consumer warpgroup, a box of 64 rows of C x 64
// columns of D (A, M-major) and two boxes of 64 rows of C x 64 columns of
// F (B, N-major).  A warpgroup writes its products through its own
// staging slice with TMA stores (store_tile_tma).  `tiles` is null or
// three int32 counters the launch adds to: tiles, tiles of an empty
// expert, K stages run.
__global__ void __launch_bounds__(kThreads, 1)
group_gemm_dw_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap ymap,
                     const __grid_constant__ CUtensorMap omap,
                     const int* __restrict__ counts,
                     __nv_bfloat16* __restrict__ dw, int* __restrict__ tiles,
                     int n_exp, int c, int d, int f) {
  extern __shared__ unsigned char smem_raw[];
  const int tiles_m = (d + kBM - 1) / kBM, tiles_n = (f + kBN - 1) / kBN;
  const int n_tiles = tiles_m * tiles_n * n_exp;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t staged = ring + kDwStages * kStageBytes;
  const uint32_t bars = staged + kConsumers * kOutSlice;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kDwStages + s); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDwStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers * 4);  // every consumer warp arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // tile t: its expert, first row of D and first column of F; the K
  // stages it runs and the warpgroups whose rows lie inside D
  struct Tile { int e, m0, n0, nk, n_wg; };
  auto tile = [&](int t) {
    Tile x;
    x.m0 = t % tiles_m * kBM;
    x.n0 = t / tiles_m % tiles_n * kBN;
    x.e = t / (tiles_m * tiles_n);
    x.nk = (min(max(counts[x.e], 0), c) + kBK - 1) / kBK;
    x.n_wg = (min(kBM, d - x.m0) + 63) / 64;
    return x;
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == kConsumers * 4) {               // the producer warp
    if (lane == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const Tile x = tile(t);
        for (int kt = 0; kt < x.nk; ++kt, ++it) {
          const int s = it % kDwStages, phase = (it / kDwStages) & 1;
          mbar_wait(empty(s), phase ^ 1);
          mbar_expect_tx(full(s), x.n_wg * kASlice + 2 * kBoxBytes);
          const uint32_t a = ring + s * kStageBytes;
          const uint32_t b = a + kConsumers * kASlice;
          for (int g = 0; g < x.n_wg; ++g)
            tma_load_3d(a + g * kASlice, &xmap, full(s), x.m0 + 64 * g,
                        kt * kBK, x.e);
          for (int h = 0; h < 2; ++h)
            tma_load_3d(b + h * kBoxBytes, &ymap, full(s), x.n0 + 64 * h,
                        kt * kBK, x.e);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;                   // consumer warpgroup
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const Tile x = tile(t);
    const int cnt = min(max(counts[x.e], 0), c);
    __nv_bfloat16* o = dw + static_cast<int64_t>(x.e) * d * f;
    if (tiles != nullptr && threadIdx.x == 0) {
      atomicAdd(tiles, 1);
      if (x.nk == 0) atomicAdd(tiles + 1, 1);
      atomicAdd(tiles + 2, x.nk);
    }
    if (x.nk == 0) {    // an empty expert: zeros, nothing loaded
      const int r0 = x.m0 + 64 * wg;
      zero_block(o, f, r0, max(0, min(64, d - r0)), x.n0, f - x.n0,
                 threadIdx.x & 127, 128);
      continue;
    }
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < x.nk; ++kt, ++it) {
      const int s = it % kDwStages, phase = (it / kDwStages) & 1;
      mbar_wait(full(s), phase);
      const uint32_t a = ring + s * kStageBytes;
      const uint32_t b = a + kConsumers * kASlice;
      const int live = cnt - kt * kBK;        // rows of C below the count
      if (live < kBK) {
        // the last stage: rows live.. of every box loaded read as zeros
        // (one 128-byte line a row, whatever the swizzle); all consumer
        // warpgroups share the work, then fence it for wgmma's reads
        const int per_box = (kBK - live) * 8;  // 16-byte pieces
        for (int i = threadIdx.x; i < (x.n_wg + 2) * per_box;
             i += kConsumers * 128) {
          const int box = i / per_box, q = i % per_box;
          const uint32_t base = box < x.n_wg
                                    ? a + box * kASlice
                                    : b + (box - x.n_wg) * kBoxBytes;
          st_shared_zero16(base + (live + q / 8) * 128 + (q % 8) * 16);
        }
        fence_proxy_async();
        consumers_sync();
      }
      if (wg < x.n_wg) {
#pragma unroll
        for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          // both M- and N-major: 16 rows of C (2,048 bytes) a step, 8-row
          // groups 1024 bytes apart; B's second 64 columns a box further
          wgmma_m64n128k16<1, 1>(
              acc, smem_desc(a + wg * kASlice + kk * 2048, kASlice, 1024),
              smem_desc(b + kk * 2048, kBoxBytes, 1024));
        wgmma_commit();
        wgmma_wait<1>();                      // the stage before is read
#pragma unroll
        for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
      }
      if (kt > 0 && lane == 0) mbar_arrive(empty((it - 1) % kDwStages));
    }
    if (wg < x.n_wg) {
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
    }
    if (lane == 0) mbar_arrive(empty((it - 1) % kDwStages));
    if (wg < x.n_wg)
      store_tile_tma(acc, staged + wg * kOutSlice, &omap, wg, x.n0,
                     x.m0 + 64 * wg, x.e, 64);
  }
  if ((threadIdx.x & 127) == 0) bulk_wait();
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

template <bool kDxe>
cudaError_t wgmma_launch(const void* a, const void* b, const int* counts,
                         void* out, int* tiles, int e, int c, int k, int n,
                         cudaStream_t stream) {
  CUtensorMap amap, bmap, omap;
  // b is [E, K, N] for the forward and [E, N, K] for dxe; dxe's out [E,
  // C, N] bf16 (the forward's float32 out takes no map: amap stands in)
  if (!make_map(&amap, a, k, c, e, 64) ||
      !(kDxe ? make_map(&bmap, b, k, n, e, 64)
             : make_map(&bmap, b, n, k, e, 64)))
    return cudaErrorInvalidValue;
  if (!kDxe) omap = amap;
  else if (!make_map(&omap, out, n, c, e, 64)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      group_gemm_wgmma_kernel<kDxe>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((c + kBM - 1) / kBM, (n + kBN - 1) / kBN, e);
  group_gemm_wgmma_kernel<kDxe><<<grid, kThreads, kSmemBytes, stream>>>(
      amap, bmap, omap, counts, out, tiles, c, k, n);
  return cudaGetLastError();
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
  return group_gemm_sm90::wgmma_launch<false>(xe, w, counts, out, tiles, e,
                                              c, d, f, stream);
}

// dxe [E, C, D] bf16 = dy [E, C, F] @ w [E, D, F]^T, the rows at or past
// counts[e] zero; bf16 rows of whole 16 bytes on 16-byte aligned bases.
cudaError_t group_gemm_dxe_wgmma_launch(const void* dy, const void* w,
                                        const int* counts, void* dxe,
                                        int* tiles, int e, int c, int d,
                                        int f, cudaStream_t stream) {
  return group_gemm_sm90::wgmma_launch<true>(dy, w, counts, dxe, tiles, e,
                                             c, f, d, stream);
}

// dw [E, D, F] bf16 = xe [E, C, D]^T @ dy [E, C, F] over the rows below
// counts[e] (C >= 1); `tiles` is null or three int32 counters (tiles,
// tiles of an empty expert, K stages run).  One persistent CTA an SM.
cudaError_t group_gemm_dw_launch(const void* xe, const void* dy,
                                 const int* counts, void* dw, int* tiles,
                                 int e, int c, int d, int f,
                                 cudaStream_t stream) {
  using namespace group_gemm_sm90;
  if (e < 0 || c < 1 || d < 0 || f < 0) return cudaErrorInvalidValue;
  const int64_t n_tiles = static_cast<int64_t>((d + kBM - 1) / kBM) *
                          ((f + kBN - 1) / kBN) * e;
  if (n_tiles == 0) return cudaSuccess;
  if (n_tiles > 0x7fffffff) return cudaErrorInvalidValue;
  CUtensorMap xmap, ymap, omap;
  if (!make_map(&xmap, xe, d, c, e, 64) ||
      !make_map(&ymap, dy, f, c, e, 64) || !make_map(&omap, dw, f, d, e, 64))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      group_gemm_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDwSmemBytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(n_tiles < sms ? n_tiles : sms);
  group_gemm_dw_kernel<<<grid, kThreads, kDwSmemBytes, stream>>>(
      xmap, ymap, omap, counts, static_cast<__nv_bfloat16*>(dw), tiles, e, c,
      d, f);
  return cudaGetLastError();
}
