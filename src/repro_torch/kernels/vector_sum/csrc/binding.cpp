// PyTorch binding of the vector-sum kernel.  The only source of this
// extension that includes PyTorch's headers; the kernel (vector_sum.cu)
// exports a plain C++ launcher.  Shapes, dtypes, devices and contiguity are
// checked by the Python wrapper in kernel.py before this is called; the
// checks here only guard memory safety.
#include <torch/extension.h>

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

cudaError_t vector_sum_launch(int dtype, const void* a, const void* b,
                              void* out, int64_t n, cudaStream_t stream);

// a, b of one shape and dtype (float32, bfloat16 or float16) -> out = a + b,
// written here
void vector_sum(torch::Tensor a, torch::Tensor b, torch::Tensor out) {
  for (const auto* t : {&a, &b, &out})
    TORCH_CHECK(t->is_cuda() && t->is_contiguous() &&
                    t->sizes() == a.sizes() &&
                    t->scalar_type() == a.scalar_type() &&
                    t->device() == a.device(),
                "vector_sum takes contiguous CUDA tensors of one shape and "
                "dtype");
  int dtype = -1;
  if (a.scalar_type() == torch::kFloat32) dtype = 0;
  if (a.scalar_type() == torch::kBFloat16) dtype = 1;
  if (a.scalar_type() == torch::kFloat16) dtype = 2;
  TORCH_CHECK(dtype >= 0, "vector_sum takes float32, bfloat16 or float16, "
              "got ", a.scalar_type());
  TORCH_CHECK(a.numel() >= 1);
  const c10::cuda::CUDAGuard guard(a.device());
  const cudaError_t err = vector_sum_launch(
      dtype, a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
      c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "vector_sum launch failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("vector_sum", &vector_sum, "elementwise a + b");
}
