// Cache-aware hot/cold split scatter-add (the paper's §5.1.3 idea) for
// sm_90a: the updates whose destination is in the hot set accumulate on
// chip; the cold ones pass through to the caller's scatter.
//
// Replaces the TPU kernel src/repro/kernels/push_scatter/kernel.py
// (`push_scatter_kernel`).  Same function: dst_hot [U] int32 is the hot
// slot of each update's destination, or -1; val [U] float32.  Outputs:
// hot_acc [hot], the sum of the values of each slot, and cold_vals [U], the
// value of every cold update and 0 for every hot one.  A slot at or past
// `hot` counts as hot and adds nothing, as in the TPU kernel's one-hot
// product.  On the TPU the grid walks 512-update tiles in order and carries
// a [1, hot] accumulator resident in VMEM from step to step, adding each
// tile through a one-hot matmul on the MXU.
//
// What bounds it on an H100: device-memory bytes, 12 per update (4 read
// from dst_hot, 4 from val, 4 written to cold_vals), one add per update.
//
// What the design does about it: the GPU analogue of the resident
// accumulator.  Each CTA zeroes a float[hot] in shared memory, walks the
// updates grid-stride (coalesced 4-byte loads, four updates of a thread in
// flight at once), adds each hot value into shared memory with an atomic
// add and writes its cold value, then adds its nonzero slots into the
// global hot_acc with one atomic add each.  hot_acc is zeroed on the stream
// first.  The grid is two CTAs per SM, so the global adds are about 264 per
// slot.  Summation order differs from run to run (atomics): results agree
// with a serial sum to the worst-case bound of float32 summation, not bit
// for bit.
#include <cuda_runtime.h>

#include <cstdint>

namespace push_scatter {

constexpr int kThreads = 512;
constexpr int kCtasPerSm = 2;
constexpr int kUnroll = 4;

__device__ __forceinline__ void scatter_one(int s, float v, float* acc,
                                            int hot, float* cold, int64_t i) {
  if (s >= 0) {
    if (s < hot) atomicAdd(acc + s, v);
    cold[i] = 0.f;
  } else {
    cold[i] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
push_scatter_kernel(const int* __restrict__ dst_hot,
                    const float* __restrict__ val, float* __restrict__ hot_acc,
                    float* __restrict__ cold, int64_t u, int hot) {
  extern __shared__ float acc[];
  for (int s = threadIdx.x; s < hot; s += kThreads) acc[s] = 0.f;
  __syncthreads();

  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < u; i += kUnroll * stride) {
    int s[kUnroll];
    float v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      s[j] = dst_hot[i + j * stride];
      v[j] = val[i + j * stride];
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      scatter_one(s[j], v[j], acc, hot, cold, i + j * stride);
  }
  for (; i < u; i += stride) scatter_one(dst_hot[i], val[i], acc, hot, cold, i);
  __syncthreads();

  for (int s = threadIdx.x; s < hot; s += kThreads) {
    const float x = acc[s];
    if (x != 0.f) atomicAdd(hot_acc + s, x);
  }
}

}  // namespace push_scatter

// Plain C++ entry point for the binding (no PyTorch headers here).  Returns
// the launch status.  hot_acc [hot] is zeroed here; 1 <= hot and hot floats
// must fit the default 48 KB of shared memory.
cudaError_t push_scatter_launch(const int* dst_hot, const float* val,
                                float* hot_acc, float* cold, int64_t u,
                                int hot, cudaStream_t stream) {
  using namespace push_scatter;
  const size_t smem = static_cast<size_t>(hot) * sizeof(float);
  if (hot < 1 || smem > 48 * 1024 || u < 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(hot_acc, 0, smem, stream);
  if (err != cudaSuccess || u == 0) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (u + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(
      tiles < static_cast<int64_t>(sms) * kCtasPerSm ? tiles
                                                    : sms * kCtasPerSm);
  push_scatter_kernel<<<grid, kThreads, smem, stream>>>(dst_hot, val, hot_acc,
                                                        cold, u, hot);
  return cudaGetLastError();
}
