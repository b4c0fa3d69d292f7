// Elementwise vector sum for sm_90a: the paper's co-aligned primitive
// (§4.2.2), out = a + b.
//
// Replaces the TPU kernel src/repro/kernels/vector_sum/kernel.py
// (`vector_sum_2d`).  Same function, a + b in the inputs' dtype (float32,
// bfloat16 or float16).  On the TPU the wrapper pads the flat length to
// rows of 512 lanes and the grid walks (8, 512) tiles, one tile of a, b
// and c per step.
//
// What bounds it on an H100: device-memory bytes, two arrays in and one
// out (6 bytes an element in 16-bit types), one add an element.
//
// What the design does about it: a pure stream.  Where a, b and out are
// all 16-byte aligned, the flat length is cut into rows of kThreads
// 16-byte chunks, and each CTA takes one contiguous span of kUnroll rows
// (64 KB of each array), one CTA for every span.  A thread issues kUnroll
// loads of a and of b, one in each row of its span, before its first
// store, so neighbouring warps read neighbouring 512-byte lines in order;
// the loads carry the streaming hint (ld.global.cs) and the stores
// evict-first (st.global.cs), so the output does not push the lines being
// read out of L2.  The grid follows from the length alone: no device
// query.  (A persistent grid of two CTAs an SM, each an even share of the
// spans, measured 5% slower on an H100 at 64 Mi float16 elements.)  The
// last span may be ragged and masks each chunk; the elements past the
// last whole chunk go through a scalar loop in the last CTA, and every
// element does when a pointer is not aligned (a grid-stride scalar loop).
// Nothing is padded.  Each sum is taken in float32 and rounded once; for
// two bfloat16 or float16 values that is the correctly rounded sum
// (float32 carries more than twice their precision plus two bits), so the
// result equals PyTorch's a + b bit for bit in every dtype.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace vector_sum {

constexpr int kThreads = 512;               // chunks of a row
constexpr int kUnroll = 8;                  // rows in flight a thread

__device__ __forceinline__ float add1(float a, float b) { return a + b; }
__device__ __forceinline__ __nv_bfloat16 add1(__nv_bfloat16 a,
                                              __nv_bfloat16 b) {
  return __float2bfloat16(__bfloat162float(a) + __bfloat162float(b));
}
__device__ __forceinline__ __half add1(__half a, __half b) {
  return __float2half_rn(__half2float(a) + __half2float(b));
}

// The sum of two 16-byte chunks of T.
__device__ __forceinline__ uint4 add16(const uint4& a, const uint4& b,
                                       float) {
  const float4 x = *reinterpret_cast<const float4*>(&a);
  const float4 y = *reinterpret_cast<const float4*>(&b);
  const float4 s = make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
  return *reinterpret_cast<const uint4*>(&s);
}
__device__ __forceinline__ uint4 add16(const uint4& a, const uint4& b,
                                       __nv_bfloat16) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  uint4 out;
  __nv_bfloat162* s = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(x[i]), q = __bfloat1622float2(y[i]);
    s[i] = __floats2bfloat162_rn(p.x + q.x, p.y + q.y);
  }
  return out;
}
__device__ __forceinline__ uint4 add16(const uint4& a, const uint4& b,
                                       __half) {
  const __half2* x = reinterpret_cast<const __half2*>(&a);
  const __half2* y = reinterpret_cast<const __half2*>(&b);
  uint4 out;
  __half2* s = reinterpret_cast<__half2*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __half22float2(x[i]), q = __half22float2(y[i]);
    s[i] = __floats2half2_rn(p.x + q.x, p.y + q.y);
  }
  return out;
}

// The CTA's span: rows [blockIdx.x * kUnroll, (blockIdx.x + 1) * kUnroll).
template <typename T>
__global__ void __launch_bounds__(kThreads)
vector_sum_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ out, int64_t n, bool aligned) {
  constexpr int kVec = 16 / sizeof(T);
  if (!aligned) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads +
                     threadIdx.x;
         i < n; i += stride)
      out[i] = add1(a[i], b[i]);
    return;
  }
  const int64_t n_vec = n / kVec;
  const int64_t whole = n_vec / kThreads;     // rows with no missing chunk
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kUnroll;
  const int64_t v0 = r * kThreads + threadIdx.x;
  const uint4* a4 = reinterpret_cast<const uint4*>(a);
  const uint4* b4 = reinterpret_cast<const uint4*>(b);
  uint4* o4 = reinterpret_cast<uint4*>(out);
  uint4 x[kUnroll], y[kUnroll];
  if (r + kUnroll <= whole) {
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      x[j] = __ldcs(a4 + v0 + j * kThreads);
      y[j] = __ldcs(b4 + v0 + j * kThreads);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      __stcs(o4 + v0 + j * kThreads, add16(x[j], y[j], T()));
  } else {                                    // the ragged last span
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t v = v0 + j * kThreads;
      x[j] = y[j] = make_uint4(0, 0, 0, 0);
      if (v < n_vec) {
        x[j] = __ldcs(a4 + v);
        y[j] = __ldcs(b4 + v);
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t v = v0 + j * kThreads;
      if (v < n_vec) __stcs(o4 + v, add16(x[j], y[j], T()));
    }
  }
  if (blockIdx.x == gridDim.x - 1)
    for (int64_t i = n_vec * kVec + threadIdx.x; i < n; i += kThreads)
      out[i] = add1(a[i], b[i]);
}

template <typename T>
static cudaError_t launch_typed(const void* a, const void* b, void* out,
                                int64_t n, cudaStream_t stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  // rows of kThreads chunks when aligned, of kThreads elements otherwise
  const int64_t work = aligned ? n / (16 / sizeof(T)) : n;
  const int64_t rows = (work + kThreads - 1) / kThreads;
  const int64_t grid = rows < 1 ? 1 : (rows + kUnroll - 1) / kUnroll;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  vector_sum_kernel<T><<<static_cast<unsigned>(grid), kThreads, 0,
                         stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(out), n, aligned);
  return cudaGetLastError();
}

}  // namespace vector_sum

// Plain C++ entry point for the binding (no PyTorch headers here).  dtype 0
// is float32, 1 bfloat16, 2 float16; n >= 1.  Returns the launch status.
cudaError_t vector_sum_launch(int dtype, const void* a, const void* b,
                              void* out, int64_t n, cudaStream_t stream) {
  using namespace vector_sum;
  if (n < 1) return cudaErrorInvalidValue;
  if (dtype == 0) return launch_typed<float>(a, b, out, n, stream);
  if (dtype == 1) return launch_typed<__nv_bfloat16>(a, b, out, n, stream);
  if (dtype == 2) return launch_typed<__half>(a, b, out, n, stream);
  return cudaErrorInvalidValue;
}
