// PyTorch binding of the hot/cold push-scatter kernel.  The only source of
// this extension that includes PyTorch's headers; the kernel
// (push_scatter.cu) exports a plain C++ launcher.  Shapes, dtypes, devices
// and contiguity are checked by the Python wrapper in kernel.py before this
// is called; the checks here only guard memory safety.
#include <torch/extension.h>

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

cudaError_t push_scatter_launch(const int* dst_hot, const float* val,
                                float* hot_acc, float* cold, int64_t u,
                                int hot, cudaStream_t stream);

// dst_hot [U] int32 (hot slot or -1), val [U] float32 -> hot_acc [hot] and
// cold [U] float32, both written here
void push_scatter(torch::Tensor dst_hot, torch::Tensor val,
                  torch::Tensor hot_acc, torch::Tensor cold) {
  for (auto* t : {&dst_hot, &val, &hot_acc, &cold})
    TORCH_CHECK(t->is_cuda() && t->is_contiguous() && t->dim() == 1,
                "push_scatter takes contiguous 1-D CUDA tensors");
  TORCH_CHECK(dst_hot.scalar_type() == torch::kInt32 &&
              val.scalar_type() == torch::kFloat32 &&
              hot_acc.scalar_type() == torch::kFloat32 &&
              cold.scalar_type() == torch::kFloat32);
  TORCH_CHECK(val.numel() == dst_hot.numel() &&
              cold.numel() == dst_hot.numel() && hot_acc.numel() >= 1);
  const c10::cuda::CUDAGuard guard(val.device());
  const cudaError_t err = push_scatter_launch(
      dst_hot.data_ptr<int>(), val.data_ptr<float>(),
      hot_acc.data_ptr<float>(), cold.data_ptr<float>(), dst_hot.numel(),
      static_cast<int>(hot_acc.numel()),
      c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "push_scatter launch failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("push_scatter", &push_scatter, "hot/cold split scatter-add");
}
