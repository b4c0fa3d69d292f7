// PyTorch binding of the sparsity-aware skinny GEMM kernels.  The only
// source of this extension that includes PyTorch's headers; the kernels
// (ss_gemm.cu) export plain C++ launchers.  Shapes, dtypes, devices and
// contiguity are checked by the Python wrapper in kernel.py before this is
// called; the checks here only guard memory safety.
#include <torch/extension.h>

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

cudaError_t ssgemm_masked_launch(int dtype, const void* a, const void* b,
                                 const int* mask, float* out, int m, int k,
                                 int n, int bk, cudaStream_t stream);
cudaError_t ssgemm_compact_launch(int dtype, const void* a, const void* b,
                                  const int* idx, const int* n_live,
                                  int budget, float* out, int m, int k, int n,
                                  int bk, cudaStream_t stream);

namespace {

int check_operands(const torch::Tensor& a, const torch::Tensor& b,
                   const torch::Tensor& out, int64_t bk) {
  for (const auto* t : {&a, &b, &out})
    TORCH_CHECK(t->is_cuda() && t->is_contiguous(),
                "ssgemm takes contiguous CUDA tensors");
  TORCH_CHECK(a.dim() == 2 && b.dim() == 2 && b.size(0) == a.size(1) &&
              out.dim() == 2 && out.size(0) == a.size(0) &&
              out.size(1) == b.size(1));
  TORCH_CHECK(b.scalar_type() == a.scalar_type() &&
              out.scalar_type() == torch::kFloat32);
  TORCH_CHECK(a.size(1) >= 1 && b.size(1) >= 1 && b.size(1) <= 16 &&
              bk >= 1);
  TORCH_CHECK(a.scalar_type() == torch::kFloat32 ||
                  a.scalar_type() == torch::kBFloat16,
              "ssgemm takes float32 or bfloat16, got ", a.scalar_type());
  return a.scalar_type() == torch::kFloat32 ? 0 : 1;
}

int64_t n_blocks(const torch::Tensor& a, int64_t bk) {
  return (a.size(1) + bk - 1) / bk;
}

void check_index(const torch::Tensor& t, int64_t numel) {
  TORCH_CHECK(t.is_cuda() && t.is_contiguous() &&
              t.scalar_type() == torch::kInt32 && t.dim() == 1 &&
              t.numel() == numel, "ssgemm index tensors are contiguous 1-D "
              "CUDA int32 of the sizes the walk reads");
}

}  // namespace

// out [M, N] = the sum over the k-blocks with mask[kb] != 0 of
// a[:, kb*bk : (kb+1)*bk] @ b[kb*bk : (kb+1)*bk]
void ssgemm_masked(torch::Tensor a, torch::Tensor b, torch::Tensor mask,
                   int64_t bk, torch::Tensor out) {
  const int dtype = check_operands(a, b, out, bk);
  check_index(mask, n_blocks(a, bk));
  const c10::cuda::CUDAGuard guard(a.device());
  const cudaError_t err = ssgemm_masked_launch(
      dtype, a.data_ptr(), b.data_ptr(), mask.data_ptr<int>(),
      out.data_ptr<float>(), static_cast<int>(a.size(0)),
      static_cast<int>(a.size(1)), static_cast<int>(b.size(1)),
      static_cast<int>(bk), c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "ssgemm_masked launch failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// the same product over the blocks idx[j], j < n_live[0] (<= budget)
void ssgemm_compact(torch::Tensor a, torch::Tensor b, torch::Tensor idx,
                    torch::Tensor n_live, int64_t bk, torch::Tensor out) {
  const int dtype = check_operands(a, b, out, bk);
  TORCH_CHECK(idx.numel() >= 1, "ssgemm_compact needs a budget >= 1");
  check_index(idx, idx.numel());
  check_index(n_live, 1);
  const c10::cuda::CUDAGuard guard(a.device());
  const cudaError_t err = ssgemm_compact_launch(
      dtype, a.data_ptr(), b.data_ptr(), idx.data_ptr<int>(),
      n_live.data_ptr<int>(), static_cast<int>(idx.numel()),
      out.data_ptr<float>(), static_cast<int>(a.size(0)),
      static_cast<int>(a.size(1)), static_cast<int>(b.size(1)),
      static_cast<int>(bk), c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "ssgemm_compact launch failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("ssgemm_masked", &ssgemm_masked,
        "skinny GEMM over the k-blocks of a mask");
  m.def("ssgemm_compact", &ssgemm_compact,
        "skinny GEMM over a compacted list of k-blocks");
}
