// PyTorch binding of the paged-attention kernels.  The only source that
// includes PyTorch's headers; the kernels themselves (paged_decode.cu,
// paged_prefill.cu) export plain C++ launchers.  Shapes, dtypes, devices
// and contiguity are checked by the Python wrappers in kernel.py before
// these are called; the checks here only guard memory safety.
#include <torch/extension.h>

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

cudaError_t paged_decode_launch(int dtype, int head_dim, const void* q,
                                const void* k, const void* v,
                                const int* table, const int* lengths,
                                void* out, int batch, int hq, int hkv,
                                int n_pages, int page_size, int table_width,
                                int splits, cudaStream_t stream);
cudaError_t paged_prefill_launch(int dtype, int head_dim, const void* q,
                                 const void* k, const void* v,
                                 const int* table, const int* q_offset,
                                 const int* kv_len, void* out, int batch,
                                 int lq, int hq, int hkv, int n_pages,
                                 int page_size, int table_width,
                                 cudaStream_t stream);

namespace {

int dtype_code(const torch::Tensor& t) {
  if (t.scalar_type() == torch::kFloat32) return 0;
  if (t.scalar_type() == torch::kBFloat16) return 1;
  TORCH_CHECK(false, "paged attention takes float32 or bfloat16, got ",
              t.scalar_type());
  return -1;
}

void check_cuda(const torch::Tensor& t, const char* name) {
  TORCH_CHECK(t.is_cuda() && t.is_contiguous(), name,
              " must be a contiguous CUDA tensor");
}

}  // namespace

// q [B, Hq, D], k/v [N, ps, Hkv, D], table [B, P] int32, lengths [B] int32,
// out [B, Hq, D] (allocated by the caller); `splits` CTAs (one cluster)
// per (slot, KV head): 1, 2, 4 or 8
void paged_decode(torch::Tensor q, torch::Tensor k, torch::Tensor v,
                  torch::Tensor table, torch::Tensor lengths,
                  torch::Tensor out, int64_t splits) {
  for (auto* t : {&q, &k, &v, &table, &lengths, &out}) check_cuda(*t, "input");
  TORCH_CHECK(q.dim() == 3 && k.dim() == 4 && table.dim() == 2);
  TORCH_CHECK(table.scalar_type() == torch::kInt32 &&
              lengths.scalar_type() == torch::kInt32);
  const c10::cuda::CUDAGuard guard(q.device());
  const cudaError_t err = paged_decode_launch(
      dtype_code(q), static_cast<int>(q.size(2)), q.data_ptr(), k.data_ptr(),
      v.data_ptr(), table.data_ptr<int>(), lengths.data_ptr<int>(),
      out.data_ptr(), static_cast<int>(q.size(0)),
      static_cast<int>(q.size(1)), static_cast<int>(k.size(2)),
      static_cast<int>(k.size(0)), static_cast<int>(k.size(1)),
      static_cast<int>(table.size(1)), static_cast<int>(splits),
      c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "paged_decode launch failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// q/out [B, Lq, Hq, D], k/v [N, ps, Hkv, D], table [B, P] int32,
// q_offset/kv_len [B] int32
void paged_prefill(torch::Tensor q, torch::Tensor k, torch::Tensor v,
                   torch::Tensor table, torch::Tensor q_offset,
                   torch::Tensor kv_len, torch::Tensor out) {
  for (auto* t : {&q, &k, &v, &table, &q_offset, &kv_len, &out})
    check_cuda(*t, "input");
  TORCH_CHECK(q.dim() == 4 && k.dim() == 4 && table.dim() == 2);
  TORCH_CHECK(table.scalar_type() == torch::kInt32 &&
              q_offset.scalar_type() == torch::kInt32 &&
              kv_len.scalar_type() == torch::kInt32);
  const c10::cuda::CUDAGuard guard(q.device());
  const cudaError_t err = paged_prefill_launch(
      dtype_code(q), static_cast<int>(q.size(3)), q.data_ptr(), k.data_ptr(),
      v.data_ptr(), table.data_ptr<int>(), q_offset.data_ptr<int>(),
      kv_len.data_ptr<int>(), out.data_ptr(), static_cast<int>(q.size(0)),
      static_cast<int>(q.size(1)), static_cast<int>(q.size(2)),
      static_cast<int>(k.size(2)), static_cast<int>(k.size(0)),
      static_cast<int>(k.size(1)), static_cast<int>(table.size(1)),
      c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "paged_prefill launch failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("paged_decode", &paged_decode, "paged GQA decode attention");
  m.def("paged_prefill", &paged_prefill, "paged GQA prefill attention");
}
