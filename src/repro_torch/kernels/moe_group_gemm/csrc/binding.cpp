// PyTorch binding of the grouped expert GEMM kernels: the forward and the
// backward's three (dy's mask and cast, dxe, dw).  The only source of this
// extension that includes PyTorch's headers; the kernels (group_gemm.cu,
// group_gemm_sm90.cu) export plain C++ launchers.  Shapes, dtypes, devices,
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
cudaError_t group_gemm_dy_launch(int dtype, const float* dy,
                                 const int* counts, void* out, int e, int c,
                                 int f, cudaStream_t stream);
cudaError_t group_gemm_dxe_launch(int dtype, const void* dy, const void* w,
                                  const int* counts, void* dxe, int* tiles,
                                  int e, int c, int d, int f, int bm,
                                  cudaStream_t stream);
cudaError_t group_gemm_dw_launch(const void* xe, const void* dy,
                                 const int* counts, void* dw, int* tiles,
                                 int e, int c, int d, int f,
                                 cudaStream_t stream);

namespace {

void check_cuda(std::initializer_list<const torch::Tensor*> ts,
                const char* name) {
  for (const torch::Tensor* t : ts)
    TORCH_CHECK(t->is_cuda() && t->is_contiguous(), name,
                " takes contiguous CUDA tensors");
}

void check_aligned(std::initializer_list<const torch::Tensor*> ts,
                   const char* name) {
  for (const torch::Tensor* t : ts)
    TORCH_CHECK(t->size(-1) * t->element_size() % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(t->data_ptr()) % 16 == 0,
                name, " takes 16-byte rows on 16-byte aligned bases");
}

int dtype_code(const torch::Tensor& t, const char* name) {
  TORCH_CHECK(t.scalar_type() == torch::kFloat32 ||
                  t.scalar_type() == torch::kBFloat16,
              name, " takes float32 or bfloat16, got ", t.scalar_type());
  return t.scalar_type() == torch::kFloat32 ? 0 : 1;
}

int* tiles_ptr(torch::Tensor& tiles, int64_t n, const char* name) {
  TORCH_CHECK(tiles.numel() == 0 ||
                  (tiles.numel() == n &&
                   tiles.scalar_type() == torch::kInt32),
              name, ": tiles is empty or int32 [", n, "]");
  return tiles.numel() ? tiles.data_ptr<int>() : nullptr;
}

void check_launch(cudaError_t err, const char* name) {
  TORCH_CHECK(err == cudaSuccess, name, " launch failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

// xe [E, C, D], w [E, D, F] (one dtype), counts [E] int32 -> out [E, C, F]
// float32; rows at or past counts[e] are written as zeros.  `tiles` is
// empty, or int32 [2] that the launch adds its tiles and skipped tiles to.
void group_gemm(torch::Tensor xe, torch::Tensor w, torch::Tensor counts,
                int64_t bm, torch::Tensor out, torch::Tensor tiles) {
  check_cuda({&xe, &w, &counts, &out, &tiles}, "group_gemm");
  TORCH_CHECK(xe.dim() == 3 && w.dim() == 3 && counts.dim() == 1 &&
              out.dim() == 3);
  TORCH_CHECK(w.size(0) == xe.size(0) && w.size(1) == xe.size(2) &&
              counts.size(0) == xe.size(0) && out.size(0) == xe.size(0) &&
              out.size(1) == xe.size(1) && out.size(2) == w.size(2));
  TORCH_CHECK(w.scalar_type() == xe.scalar_type() &&
              counts.scalar_type() == torch::kInt32 &&
              out.scalar_type() == torch::kFloat32);
  check_aligned({&xe, &w}, "group_gemm");
  const c10::cuda::CUDAGuard guard(xe.device());
  check_launch(group_gemm_launch(
                   dtype_code(xe, "group_gemm"), xe.data_ptr(), w.data_ptr(),
                   counts.data_ptr<int>(), out.data_ptr<float>(),
                   tiles_ptr(tiles, 2, "group_gemm"),
                   static_cast<int>(xe.size(0)), static_cast<int>(xe.size(1)),
                   static_cast<int>(xe.size(2)), static_cast<int>(w.size(2)),
                   static_cast<int>(bm),
                   c10::cuda::getCurrentCUDAStream().stream()),
               "group_gemm");
}

// dy [E, C, F] float32, counts [E] int32 -> out [E, C, F] float32 or
// bfloat16: dy's rows below counts[e], zeros past them.
void group_gemm_dy(torch::Tensor dy, torch::Tensor counts,
                   torch::Tensor out) {
  check_cuda({&dy, &counts, &out}, "group_gemm_dy");
  TORCH_CHECK(dy.dim() == 3 && counts.dim() == 1 && out.sizes() == dy.sizes()
              && counts.size(0) == dy.size(0));
  TORCH_CHECK(dy.scalar_type() == torch::kFloat32 &&
              counts.scalar_type() == torch::kInt32);
  check_aligned({&dy, &out}, "group_gemm_dy");
  const c10::cuda::CUDAGuard guard(dy.device());
  check_launch(group_gemm_dy_launch(
                   dtype_code(out, "group_gemm_dy"), dy.data_ptr<float>(),
                   counts.data_ptr<int>(), out.data_ptr(),
                   static_cast<int>(dy.size(0)), static_cast<int>(dy.size(1)),
                   static_cast<int>(dy.size(2)),
                   c10::cuda::getCurrentCUDAStream().stream()),
               "group_gemm_dy");
}

// dy [E, C, F], w [E, D, F] (one dtype), counts [E] int32 -> dxe [E, C, D]
// = dy @ w^T, rows at or past counts[e] zero: bfloat16 for bm 256, else
// float32.  `tiles` is empty or int32 [2].
void group_gemm_dxe(torch::Tensor dy, torch::Tensor w, torch::Tensor counts,
                    int64_t bm, torch::Tensor out, torch::Tensor tiles) {
  check_cuda({&dy, &w, &counts, &out, &tiles}, "group_gemm_dxe");
  TORCH_CHECK(dy.dim() == 3 && w.dim() == 3 && counts.dim() == 1 &&
              out.dim() == 3);
  TORCH_CHECK(w.size(0) == dy.size(0) && w.size(2) == dy.size(2) &&
              counts.size(0) == dy.size(0) && out.size(0) == dy.size(0) &&
              out.size(1) == dy.size(1) && out.size(2) == w.size(1));
  TORCH_CHECK(w.scalar_type() == dy.scalar_type() &&
              counts.scalar_type() == torch::kInt32 &&
              out.scalar_type() == (bm == 256 ? torch::kBFloat16
                                              : torch::kFloat32));
  check_aligned({&dy, &w, &out}, "group_gemm_dxe");
  const c10::cuda::CUDAGuard guard(dy.device());
  check_launch(group_gemm_dxe_launch(
                   dtype_code(dy, "group_gemm_dxe"), dy.data_ptr(),
                   w.data_ptr(), counts.data_ptr<int>(), out.data_ptr(),
                   tiles_ptr(tiles, 2, "group_gemm_dxe"),
                   static_cast<int>(dy.size(0)), static_cast<int>(dy.size(1)),
                   static_cast<int>(w.size(1)), static_cast<int>(w.size(2)),
                   static_cast<int>(bm),
                   c10::cuda::getCurrentCUDAStream().stream()),
               "group_gemm_dxe");
}

// xe [E, C, D], dy [E, C, F] bfloat16, counts [E] int32 -> dw [E, D, F]
// bfloat16 = xe^T @ dy over the rows below counts[e].  `tiles` is empty
// or int32 [3].
void group_gemm_dw(torch::Tensor xe, torch::Tensor dy, torch::Tensor counts,
                   torch::Tensor out, torch::Tensor tiles) {
  check_cuda({&xe, &dy, &counts, &out, &tiles}, "group_gemm_dw");
  TORCH_CHECK(xe.dim() == 3 && dy.dim() == 3 && counts.dim() == 1 &&
              out.dim() == 3);
  TORCH_CHECK(dy.size(0) == xe.size(0) && dy.size(1) == xe.size(1) &&
              counts.size(0) == xe.size(0) && out.size(0) == xe.size(0) &&
              out.size(1) == xe.size(2) && out.size(2) == dy.size(2));
  TORCH_CHECK(xe.scalar_type() == torch::kBFloat16 &&
              dy.scalar_type() == torch::kBFloat16 &&
              out.scalar_type() == torch::kBFloat16 &&
              counts.scalar_type() == torch::kInt32,
              "group_gemm_dw takes bfloat16 and int32 counts");
  check_aligned({&xe, &dy, &out}, "group_gemm_dw");
  const c10::cuda::CUDAGuard guard(xe.device());
  check_launch(group_gemm_dw_launch(
                   xe.data_ptr(), dy.data_ptr(), counts.data_ptr<int>(),
                   out.data_ptr(), tiles_ptr(tiles, 3, "group_gemm_dw"),
                   static_cast<int>(xe.size(0)), static_cast<int>(xe.size(1)),
                   static_cast<int>(xe.size(2)), static_cast<int>(dy.size(2)),
                   c10::cuda::getCurrentCUDAStream().stream()),
               "group_gemm_dw");
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("group_gemm", &group_gemm,
        "per-expert GEMM over capacity slabs, tiles past the count skipped");
  m.def("group_gemm_dy", &group_gemm_dy,
        "dy's live rows in the working dtype, zeros past each count");
  m.def("group_gemm_dxe", &group_gemm_dxe,
        "dxe = dy @ w^T per expert, w read as it lies");
  m.def("group_gemm_dw", &group_gemm_dw,
        "dw = xe^T @ dy per expert over its live rows");
}
