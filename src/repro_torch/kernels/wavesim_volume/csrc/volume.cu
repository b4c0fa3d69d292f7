// DGM volume term for sm_90a: rhs rows = u rows @ W, with W the fused
// 27 x 27 reference derivative operator (the sum of the three directional
// Kronecker operators times c, stored transposed), taken as its 7-point
// stencil.
//
// Replaces the TPU kernel src/repro/kernels/wavesim_volume/kernel.py
// (`volume_kernel`).  Same function: x [R, 27] (one row per element and
// field, node index i*9 + j*3 + k), out[r, j] = sum_i x[r, i] * W[i, j],
// summed in float32 and written in x's dtype (float32 or bfloat16).  On
// the TPU each grid step stages 256 rows padded to 32 lanes through VMEM
// and multiplies them by the resident W on the MXU.
//
// The stencil.  W[i, j] can be nonzero only where nodes i and j differ in
// at most one of (i, j, k): 7 inputs an output, 189 of the 729 entries.
// The wrapper hands the kernel those 189 values (kernel.py::
// stencil_operator, which refuses a W with anything off the pattern), in
// the order of in_node() below: for output j, its 7 inputs in ascending
// node order.  Each output is a chain of 7 fused multiply-adds from 0 in
// that order, in float32.  The dense chain of 27 in node order takes the
// same 7 products in the same order plus 20 products by an exact zero,
// which leave a nonzero sum as it is, so for finite x the two agree bit
// for bit apart from the sign of a zero sum; the error bound tightens from
// gamma(27) to gamma(7) times the sum of |terms|.
//
// What bounds it on an H100: device-memory bytes.  Every row is read once
// and written once (108 bytes a row in float32, 54 in bfloat16) against
// 189 multiply-adds, 3.5 and 7 operations a byte: a tenth (float32) and a
// sixth (bfloat16) of what the CUDA cores could issue in the time the
// bytes take.
//
// What the design does about it: persistent CTAs, kCtasPerSm an SM (the
// wrapper sizes the grid from the SM count), each walking the 256-row
// tiles blockIdx.x, blockIdx.x + gridDim.x, ... over a ring of kStages
// tile stages in shared memory, in x's dtype (27,648 bytes a stage in
// float32, 13,824 in bfloat16: both multiples of 16, so every tile
// starts as aligned as the tensor does).  One thread fills a stage
// with one TMA bulk copy (cp.async.bulk, completing on the stage's
// mbarrier) and keeps the loads kStages - 1 tiles ahead of the compute.
// Each thread computes one row from the stage: the row stride of 27
// values is odd, so a warp's rows fall in distinct banks; bfloat16 is
// widened to float32 in registers; the 189 stencil values are a
// __grid_constant__ parameter, so each multiply-add takes its weight from
// the constant bank as an operand, with no load of its own.  Results go
// back over the thread's own row of the stage, and one thread sends the
// tile home with one bulk store (bulk_group), which overlaps the next
// tile's compute; a stage is refilled only once its store has read it
// (wait_group.read).  Tiles the bulk copies cannot take (every tile when x
// or out is not 16-byte aligned, else the ragged last tile) go through a
// plain path after the walk: coalesced element loads into a stage, the
// same row compute, coalesced element stores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace wavesim_volume {

constexpr int kNodes = 27;
constexpr int kTerms = 7;                    // inputs of an output
constexpr int kStencil = kNodes * kTerms;    // 189
constexpr int kRows = 256;                   // rows of a tile = threads
constexpr int kTile = kRows * kNodes;        // 6,912 values
constexpr int kStages = 3;
constexpr int kCtasPerSm = 2;

struct Stencil {
  float s[kStencil];                         // s[j * 7 + t]
};

// Input node t (0..6) of output node j: the nodes that differ from j in at
// most one of (i, j, k), in ascending order.
__host__ __device__ constexpr int in_node(int j, int t) {
  const int a = j / 9, b = j / 3 % 3, c = j % 3;
  if (t < a) return t * 9 + b * 3 + c;                  // i below
  t -= a;
  if (t < b) return a * 9 + t * 3 + c;                  // j below
  t -= b;
  if (t < 3) return a * 9 + b * 3 + t;                  // k, j itself
  t -= 3;
  if (t < 2 - b) return a * 9 + (b + 1 + t) * 3 + c;    // j above
  t -= 2 - b;
  return (a + 1 + t) * 9 + b * 3 + c;                   // i above
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
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
// `bytes` contiguous bytes from device memory into shared memory,
// completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(bar)
      : "memory");
}
// `bytes` contiguous bytes from shared memory to device memory, as one
// bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n"
      :: "l"(reinterpret_cast<uint64_t>(dst)), "r"(src), "r"(bytes)
      : "memory");
}
// At most N bulk groups still reading their shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// This thread's writes to shared memory, visible to the bulk copies.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One row in place: its 27 values into registers, then each output a
// chain of 7 fused multiply-adds, written over the row.
template <typename T>
__device__ __forceinline__ void row_apply(T* row, const Stencil& op) {
  float x[kNodes];
#pragma unroll
  for (int i = 0; i < kNodes; ++i) x[i] = to_f32(row[i]);
#pragma unroll
  for (int j = 0; j < kNodes; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < kTerms; ++t)
      acc = fmaf(x[in_node(j, t)], op.s[j * kTerms + t], acc);
    from_f32(acc, row + j);
  }
}

template <typename T>
__global__ void __launch_bounds__(kRows, kCtasPerSm)
volume_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t rows,
              int bulk, const __grid_constant__ Stencil op) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr uint32_t kTileBytes = kTile * sizeof(T);
  T* stage = reinterpret_cast<T*>(smem);
  const uint32_t ring = smem_u32(smem);
  const uint32_t bars = ring + kStages * kTileBytes;
  const int64_t grid = gridDim.x;
  const int64_t n_tiles = (rows + kRows - 1) / kRows;
  // tiles moved by bulk copies: the whole ones, when x and out are aligned
  const int64_t n_bulk = bulk ? rows / kRows : 0;
  const int64_t mine = n_bulk > blockIdx.x
                           ? (n_bulk - 1 - blockIdx.x) / grid + 1 : 0;
  auto tile_of = [&](int64_t k) { return blockIdx.x + k * grid; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kStages - 1 && s < mine; ++s) {
      mbar_expect_tx(bars + 8 * s, kTileBytes);
      bulk_load(ring + s * kTileBytes, x + tile_of(s) * kTile, kTileBytes,
                bars + 8 * s);
    }
  }
  __syncthreads();

  for (int64_t k = 0; k < mine; ++k) {
    const int s = static_cast<int>(k % kStages);
    mbar_wait(bars + 8 * s, static_cast<uint32_t>((k / kStages) & 1));
    row_apply(stage + s * kTile + threadIdx.x * kNodes, op);
    fence_async_shared();
    __syncthreads();                   // the whole tile is in the stage
    if (threadIdx.x == 0) {
      bulk_store(out + tile_of(k) * kTile, ring + s * kTileBytes,
                 kTileBytes);
      const int64_t ahead = k + kStages - 1;
      if (ahead < mine) {
        // stage (k - 1) % kStages: refilled once tile k - 1's store has
        // read it
        bulk_wait_read<1>();
        const int s2 = static_cast<int>(ahead % kStages);
        mbar_expect_tx(bars + 8 * s2, kTileBytes);
        bulk_load(ring + s2 * kTileBytes, x + tile_of(ahead) * kTile,
                  kTileBytes, bars + 8 * s2);
      }
    }
  }
  if (threadIdx.x == 0) bulk_wait_all();
  __syncthreads();                     // no copy touches the ring now

  // the plain path, on stage 0: the tiles past n_bulk, dealt out in the
  // walk's own order (tile t to CTA t % grid)
  for (int64_t t = n_bulk + (blockIdx.x + grid - n_bulk % grid) % grid;
       t < n_tiles; t += grid) {
    const int64_t row0 = t * kRows;
    const int n_rows = static_cast<int>(
        rows - row0 < kRows ? rows - row0 : kRows);
    const int n = n_rows * kNodes;
    const T* src = x + row0 * kNodes;
    T* dst = out + row0 * kNodes;
    for (int e = threadIdx.x; e < n; e += kRows) stage[e] = src[e];
    __syncthreads();
    if (threadIdx.x < n_rows) row_apply(stage + threadIdx.x * kNodes, op);
    __syncthreads();
    for (int e = threadIdx.x; e < n; e += kRows) dst[e] = stage[e];
    __syncthreads();                   // before the next tile's loads
  }
}

template <typename T>
constexpr int smem_bytes() {
  return kStages * kTile * static_cast<int>(sizeof(T)) + 8 * kStages;
}

// The grid is the wrapper's: one CTA a tile up to kCtasPerSm an SM, from
// the SM count it reads once a device (kernel.py::volume_cuda).
template <typename T>
static cudaError_t launch_typed(const void* x, void* out, int64_t rows,
                                const Stencil& op, int grid,
                                cudaStream_t stream) {
  // the ring's shared memory is past the 48 KB a launch gets by default
  const cudaError_t err = cudaFuncSetAttribute(
      volume_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<T>());
  if (err != cudaSuccess) return err;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  volume_kernel<T><<<grid, kRows, smem_bytes<T>(), stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), rows, aligned ? 1 : 0,
      op);
  return cudaGetLastError();
}

}  // namespace wavesim_volume

// Plain C++ entry point for the binding (no PyTorch headers here).  dtype 0
// is float32, 1 bfloat16; s holds the 189 float32 stencil values (host
// memory), s[j * 7 + t] for output j and its input in_node(j, t); grid
// is the persistent grid, 1 to the tiles of 256 rows.  Returns the launch
// status; rows >= 1.
cudaError_t wavesim_volume_launch(int dtype, const void* x, void* out,
                                  int64_t rows, const float* s, int grid,
                                  cudaStream_t stream) {
  using namespace wavesim_volume;
  if (rows < 1 || grid < 1 || grid > (rows + kRows - 1) / kRows)
    return cudaErrorInvalidValue;
  Stencil op;
  for (int i = 0; i < kStencil; ++i) op.s[i] = s[i];
  if (dtype == 0)
    return launch_typed<float>(x, out, rows, op, grid, stream);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(x, out, rows, op, grid, stream);
  return cudaErrorInvalidValue;
}
