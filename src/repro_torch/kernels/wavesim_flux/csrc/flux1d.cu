// Periodic 1-D face flux for sm_90a: the wavesim-flux halo exchange along
// a linearized element axis.
//
// Replaces the TPU kernel src/repro/kernels/wavesim_flux/kernel.py
// (`flux1d_kernel`).  Same function: hi, lo [E, T] (each element's high and
// low face traces), periodic along E:
//   fhi[i, t] = alpha * (lo[(i + 1) mod E, t] - hi[i, t])
//   flo[i, t] = alpha * (hi[(i - 1) mod E, t] - lo[i, t])
// in float32 or bfloat16.  On the TPU each grid step owns 256 elements and
// reads its halos from whole shifted copies of hi and lo (built by the
// wrapper with jnp.roll, E padded to the tile with wrapped rows and the
// seam repaired after the call), so that every block read is a plain
// blocked index map.
//
// What bounds it on an H100: device-memory bytes, two arrays in and two
// out (16 bytes an entry in float32, 8 in bfloat16), three operations an
// entry.
//
// What the design does about it: a grid-stride loop over the E * T
// entries, neighbouring threads on neighbouring entries, so every load and
// store is coalesced.  The neighbour is taken by index arithmetic, i + T
// or i - T wrapped into [0, E * T): no copy, no pad, no seam fix (E = 1
// makes each element its own neighbour, as in JAX).  The neighbours' rows
// are the rows the CTAs T entries away read in the same pass, so they come
// from L2 and device memory sees each array about once.  Computed in
// float32 and rounded once to the output dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace wavesim_flux {

constexpr int kThreads = 256;
constexpr int kCtasPerSm = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float x, float* out) { *out = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flux1d_kernel(const T* __restrict__ hi, const T* __restrict__ lo,
              T* __restrict__ fhi, T* __restrict__ flo, int64_t total,
              int64_t t, float alpha) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < total; i += stride) {
    int64_t next = i + t;                  // (row + 1) mod E, same column
    if (next >= total) next -= total;
    int64_t prev = i - t;                  // (row - 1) mod E
    if (prev < 0) prev += total;
    const float h = to_f32(hi[i]), l = to_f32(lo[i]);
    store(alpha * (to_f32(lo[next]) - h), fhi + i);
    store(alpha * (to_f32(hi[prev]) - l), flo + i);
  }
}

template <typename T>
cudaError_t launch_typed(const void* hi, const void* lo, void* fhi,
                         void* flo, int64_t e, int64_t t, float alpha,
                         cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t total = e * t;
  const int64_t tiles = (total + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * kCtasPerSm;
  const int grid = static_cast<int>(tiles < cap ? tiles : cap);
  flux1d_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(hi), static_cast<const T*>(lo),
      static_cast<T*>(fhi), static_cast<T*>(flo), total, t, alpha);
  return cudaGetLastError();
}

}  // namespace wavesim_flux

// Plain C++ entry point for the binding (no PyTorch headers here).  dtype 0
// is float32, 1 bfloat16; e, t >= 1.  Returns the launch status.
cudaError_t flux1d_launch(int dtype, const void* hi, const void* lo,
                          void* fhi, void* flo, int64_t e, int64_t t,
                          float alpha, cudaStream_t stream) {
  using namespace wavesim_flux;
  if (e < 1 || t < 1) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_typed<float>(hi, lo, fhi, flo, e, t, alpha, stream);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(hi, lo, fhi, flo, e, t, alpha, stream);
  return cudaErrorInvalidValue;
}
