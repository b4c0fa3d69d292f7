// PyTorch binding of the wavesim-volume kernel.  The only source of this
// extension that includes PyTorch's headers; the kernel (volume.cu)
// exports a plain C++ launcher.  Shapes, dtypes, devices and contiguity are
// checked by the Python wrapper in kernel.py before this is called; the
// checks here only guard memory safety.
#include <torch/extension.h>

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

cudaError_t wavesim_volume_launch(int dtype, const void* x, void* out,
                                  int64_t rows, const float* s, int grid,
                                  cudaStream_t stream);

// x [R, 27] float32 or bfloat16 on the card, s [189] float32 on the host
// (the operator's 7-point stencil, passed to the kernel by value) -> out =
// x @ W, in x's dtype, written here, by `grid` persistent CTAs
void volume(torch::Tensor x, torch::Tensor s, torch::Tensor out,
            int64_t grid) {
  for (const auto* t : {&x, &out})
    TORCH_CHECK(t->is_cuda() && t->is_contiguous() && t->dim() == 2 &&
                    t->size(1) == 27,
                "volume takes contiguous [R, 27] CUDA tensors");
  TORCH_CHECK(out.sizes() == x.sizes() &&
              out.scalar_type() == x.scalar_type() &&
              out.device() == x.device());
  TORCH_CHECK(x.scalar_type() == torch::kFloat32 ||
                  x.scalar_type() == torch::kBFloat16,
              "volume takes float32 or bfloat16, got ", x.scalar_type());
  TORCH_CHECK(!s.is_cuda() && s.is_contiguous() &&
                  s.scalar_type() == torch::kFloat32 && s.numel() == 189,
              "volume takes the stencil as 189 contiguous float32 values on "
              "the host");
  TORCH_CHECK(x.size(0) >= 1 && grid >= 1 &&
              grid <= (x.size(0) + 255) / 256);
  const c10::cuda::CUDAGuard guard(x.device());
  const cudaError_t err = wavesim_volume_launch(
      x.scalar_type() == torch::kFloat32 ? 0 : 1, x.data_ptr(),
      out.data_ptr(), x.size(0), s.data_ptr<float>(),
      static_cast<int>(grid), c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "volume launch failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("volume", &volume,
        "DGM volume term: [R, 27] rows @ W, W as its 7-point stencil");
}
