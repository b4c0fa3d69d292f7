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
// What the design does about it: a grid-stride loop over the flat length,
// 16-byte loads and stores (4 or 8 elements a thread) where a, b and out
// are all 16-byte aligned, four chunks of a thread in flight at once, and
// a scalar loop for the tail (and for every element when a pointer is not
// aligned).  Nothing is padded.  Each sum is taken in float32 and rounded
// once; for two bfloat16 or float16 values that is the correctly rounded
// sum (float32 carries more than twice their precision plus two bits), so
// the result equals PyTorch's a + b bit for bit in every dtype.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace vector_sum {

constexpr int kThreads = 256;
constexpr int kCtasPerSm = 8;
constexpr int kUnroll = 4;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
vector_sum_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ out, int64_t n, bool aligned) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  int64_t done = 0;
  if (aligned) {
    const int64_t n_vec = n / kVec;
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const uint4* b4 = reinterpret_cast<const uint4*>(b);
    uint4* o4 = reinterpret_cast<uint4*>(out);
    int64_t v = tid;
    for (; v + (kUnroll - 1) * stride < n_vec; v += kUnroll * stride) {
      uint4 x[kUnroll], y[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        x[j] = a4[v + j * stride];
        y[j] = b4[v + j * stride];
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) o4[v + j * stride] = add16(x[j], y[j],
                                                                   T());
    }
    for (; v < n_vec; v += stride) o4[v] = add16(a4[v], b4[v], T());
    done = n_vec * kVec;
  }
  for (int64_t i = done + tid; i < n; i += stride) out[i] = add1(a[i], b[i]);
}

template <typename T>
cudaError_t launch_typed(const void* a, const void* b, void* out, int64_t n,
                         cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const bool aligned = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t work = aligned ? (n * sizeof(T) + 15) / 16 : n;
  const int64_t tiles = (work + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * kCtasPerSm;
  const int grid = static_cast<int>(tiles < cap ? tiles : cap);
  vector_sum_kernel<T><<<grid, kThreads, 0, stream>>>(
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
