// PyTorch binding of the grouped expert GEMM kernel.  The only source of
// this extension that includes PyTorch's headers; the kernel
// (group_gemm.cu) exports a plain C++ launcher.  Shapes, dtypes, devices,
// contiguity and the tiling are checked by the Python wrapper in kernel.py
// before this is called; the checks here only guard memory safety.
#include <torch/extension.h>

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

cudaError_t group_gemm_launch(int dtype, const void* xe, const void* w,
                              const int* counts, float* out, int* tiles,
                              int e, int c, int d, int f, int bm,
                              cudaStream_t stream);

// xe [E, C, D], w [E, D, F] (one dtype), counts [E] int32 -> out [E, C, F]
// float32; rows at or past counts[e] are written as zeros.  `tiles` is
// empty, or int32 [2] that the launch adds its tiles and skipped tiles to.
void group_gemm(torch::Tensor xe, torch::Tensor w, torch::Tensor counts,
                int64_t bm, torch::Tensor out, torch::Tensor tiles) {
  for (auto* t : {&xe, &w, &counts, &out, &tiles})
    TORCH_CHECK(t->is_cuda() && t->is_contiguous(),
                "group_gemm takes contiguous CUDA tensors");
  TORCH_CHECK(xe.dim() == 3 && w.dim() == 3 && counts.dim() == 1 &&
              out.dim() == 3);
  TORCH_CHECK(w.size(0) == xe.size(0) && w.size(1) == xe.size(2) &&
              counts.size(0) == xe.size(0) && out.size(0) == xe.size(0) &&
              out.size(1) == xe.size(1) && out.size(2) == w.size(2));
  TORCH_CHECK(w.scalar_type() == xe.scalar_type() &&
              counts.scalar_type() == torch::kInt32 &&
              out.scalar_type() == torch::kFloat32);
  TORCH_CHECK(xe.scalar_type() == torch::kFloat32 ||
                  xe.scalar_type() == torch::kBFloat16,
              "group_gemm takes float32 or bfloat16, got ",
              xe.scalar_type());
  const int elem = xe.scalar_type() == torch::kFloat32 ? 4 : 2;
  TORCH_CHECK(xe.size(2) * elem % 16 == 0 && w.size(2) * elem % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(xe.data_ptr()) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(w.data_ptr()) % 16 == 0,
              "group_gemm takes 16-byte rows on 16-byte aligned bases");
  TORCH_CHECK(tiles.numel() == 0 ||
                  (tiles.numel() == 2 && tiles.scalar_type() == torch::kInt32),
              "group_gemm: tiles is empty or int32 [2]");
  const int dtype = xe.scalar_type() == torch::kFloat32 ? 0 : 1;
  const c10::cuda::CUDAGuard guard(xe.device());
  const cudaError_t err = group_gemm_launch(
      dtype, xe.data_ptr(), w.data_ptr(), counts.data_ptr<int>(),
      out.data_ptr<float>(),
      tiles.numel() ? tiles.data_ptr<int>() : nullptr,
      static_cast<int>(xe.size(0)), static_cast<int>(xe.size(1)),
      static_cast<int>(xe.size(2)), static_cast<int>(w.size(2)),
      static_cast<int>(bm),
      c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "group_gemm launch failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("group_gemm", &group_gemm,
        "per-expert GEMM over capacity slabs, tiles past the count skipped");
}
