// PyTorch binding of the periodic face-flux kernel.  The only source of
// this extension that includes PyTorch's headers; the kernel (flux1d.cu)
// exports a plain C++ launcher.  Shapes, dtypes, devices and contiguity are
// checked by the Python wrapper in kernel.py before this is called; the
// checks here only guard memory safety.
#include <torch/extension.h>

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

cudaError_t flux1d_launch(int dtype, const void* hi, const void* lo,
                          void* fhi, void* flo, int64_t e, int64_t t,
                          float alpha, cudaStream_t stream);

// hi, lo [E, T] float32 or bfloat16 -> fhi, flo [E, T], written here
void flux1d(torch::Tensor hi, torch::Tensor lo, double alpha,
            torch::Tensor fhi, torch::Tensor flo) {
  for (const auto* t : {&hi, &lo, &fhi, &flo})
    TORCH_CHECK(t->is_cuda() && t->is_contiguous() && t->dim() == 2 &&
                    t->sizes() == hi.sizes() &&
                    t->scalar_type() == hi.scalar_type(),
                "flux1d takes contiguous [E, T] CUDA tensors of one dtype");
  TORCH_CHECK(hi.scalar_type() == torch::kFloat32 ||
                  hi.scalar_type() == torch::kBFloat16,
              "flux1d takes float32 or bfloat16, got ", hi.scalar_type());
  TORCH_CHECK(hi.size(0) >= 1 && hi.size(1) >= 1);
  const c10::cuda::CUDAGuard guard(hi.device());
  const cudaError_t err = flux1d_launch(
      hi.scalar_type() == torch::kFloat32 ? 0 : 1, hi.data_ptr(),
      lo.data_ptr(), fhi.data_ptr(), flo.data_ptr(), hi.size(0), hi.size(1),
      static_cast<float>(alpha), c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "flux1d launch failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("flux1d", &flux1d, "periodic 1-D face flux over [E, T]");
}
