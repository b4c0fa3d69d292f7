// DGM volume term for sm_90a: rhs rows = u rows @ W, with W the fused
// 27 x 27 reference derivative operator (the sum of the three directional
// Kronecker operators times c, stored transposed).
//
// Replaces the TPU kernel src/repro/kernels/wavesim_volume/kernel.py
// (`volume_kernel`).  Same function: x [R, 27] (one row per element and
// field, node index i*9 + j*3 + k), out[r, j] = sum_i x[r, i] * W[i, j],
// summed in float32 and written in x's dtype (float32 or bfloat16).  On
// the TPU each grid step stages 256 rows padded to 32 lanes through VMEM
// and multiplies them by the resident W on the MXU.
//
// What bounds it on an H100: device-memory bytes.  Every row is read once
// and written once (108 bytes a row in float32, 54 in bfloat16) against
// 729 multiply-adds, 6.75 operations per byte in float32 and 13.5 in
// bfloat16: below the CUDA cores' float32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20), so the bytes set the bound.
//
// What the design does about it: one CTA of 256 threads per tile of 256
// rows (6,912 contiguous values, as the TPU's tile).  The CTA loads the
// tile with coalesced 16-byte loads (a scalar path where u or out is not
// 16-byte aligned, and for the ragged end of the last tile) into shared
// memory, widened to float32; the rows are read in place, 27 wide, with
// no padding.  Each thread then computes one row: its 27 values in
// registers, each output a chain of 27 fused multiply-adds in node order,
// written back over its own row in shared memory.  The row stride of 27
// floats is odd, so a warp's 32 rows fall in 32 different banks.  W is a
// kernel parameter (the constant bank): every lane of a warp reads the
// same entry at once, which the constant cache broadcasts, and the
// multiply-adds take it as an operand with no load of their own.  The
// tile then goes back to device memory through 16-byte stores in x's
// dtype.  The products are dense (729 a row); the Kronecker structure
// would need 243.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace wavesim_volume {

constexpr int kNodes = 27;
constexpr int kRows = 256;                 // rows of a tile = threads of a CTA
constexpr int kTile = kRows * kNodes;      // 6,912 values

struct Operator {
  float w[kNodes * kNodes];                // W[i * 27 + j]
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16(x);
}

// One 16-byte chunk of the tile, widened into shared memory (4 float32
// values, or 8 bfloat16), and back.
__device__ __forceinline__ void widen(const uint4& raw, float* dst, float) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&raw);
}
__device__ __forceinline__ void widen(const uint4& raw, float* dst,
                                      __nv_bfloat16) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(p[0]), b = __bfloat1622float2(p[1]);
  const float2 c = __bfloat1622float2(p[2]), d = __bfloat1622float2(p[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}
__device__ __forceinline__ uint4 narrow(const float* src, float) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  return *reinterpret_cast<const uint4*>(&v);
}
__device__ __forceinline__ uint4 narrow(const float* src, __nv_bfloat16) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  uint4 raw;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
  p[0] = __floats2bfloat162_rn(a.x, a.y);
  p[1] = __floats2bfloat162_rn(a.z, a.w);
  p[2] = __floats2bfloat162_rn(b.x, b.y);
  p[3] = __floats2bfloat162_rn(b.z, b.w);
  return raw;
}

template <typename T>
__global__ void __launch_bounds__(kRows)
volume_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t rows,
              bool aligned, const __grid_constant__ Operator op) {
  __shared__ __align__(16) float tile[kTile];
  constexpr int kVec = 16 / sizeof(T);     // values per 16-byte chunk
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int n_rows = static_cast<int>(
      rows - row0 < kRows ? rows - row0 : kRows);
  const int n = n_rows * kNodes;
  // a tile is 27,648 (float32) or 13,824 (bfloat16) bytes, a multiple of
  // 16, so every tile starts as aligned as the tensor does
  const T* src = x + row0 * kNodes;
  T* dst = out + row0 * kNodes;
  const int n_vec = aligned ? n / kVec : 0;

#pragma unroll 4
  for (int v = threadIdx.x; v < n_vec; v += kRows)
    widen(reinterpret_cast<const uint4*>(src)[v], tile + v * kVec, T());
  for (int e = n_vec * kVec + threadIdx.x; e < n; e += kRows)
    tile[e] = to_f32(src[e]);
  __syncthreads();

  if (threadIdx.x < n_rows) {
    float* row = tile + threadIdx.x * kNodes;
    float xr[kNodes];
#pragma unroll
    for (int i = 0; i < kNodes; ++i) xr[i] = row[i];
#pragma unroll
    for (int j = 0; j < kNodes; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kNodes; ++i)
        acc = fmaf(xr[i], op.w[i * kNodes + j], acc);
      row[j] = acc;                        // this thread's row only
    }
  }
  __syncthreads();

#pragma unroll 4
  for (int v = threadIdx.x; v < n_vec; v += kRows)
    reinterpret_cast<uint4*>(dst)[v] = narrow(tile + v * kVec, T());
  for (int e = n_vec * kVec + threadIdx.x; e < n; e += kRows)
    from_f32(tile[e], dst + e);
}

template <typename T>
cudaError_t launch_typed(const void* x, void* out, int64_t rows,
                         const Operator& op, cudaStream_t stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t tiles = (rows + kRows - 1) / kRows;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  volume_kernel<T><<<static_cast<unsigned>(tiles), kRows, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), rows, aligned, op);
  return cudaGetLastError();
}

}  // namespace wavesim_volume

// Plain C++ entry point for the binding (no PyTorch headers here).  dtype 0
// is float32, 1 bfloat16; w holds the 729 float32 values of W (host
// memory), row-major W[i][j].  Returns the launch status; rows >= 1.
cudaError_t wavesim_volume_launch(int dtype, const void* x, void* out,
                                  int64_t rows, const float* w,
                                  cudaStream_t stream) {
  using namespace wavesim_volume;
  if (rows < 1) return cudaErrorInvalidValue;
  Operator op;
  for (int i = 0; i < kNodes * kNodes; ++i) op.w[i] = w[i];
  if (dtype == 0) return launch_typed<float>(x, out, rows, op, stream);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(x, out, rows, op, stream);
  return cudaErrorInvalidValue;
}
