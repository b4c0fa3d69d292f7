// PyTorch binding of the dense-stripe decode-attention kernel.  The only
// source of this extension that includes PyTorch's headers; the kernel
// (decode_attn.cu) exports a plain C++ launcher.  Shapes, dtypes, devices
// and contiguity are checked by the Python wrapper in kernel.py before this
// is called; the checks here only guard memory safety.
#include <torch/extension.h>

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

cudaError_t decode_attn_launch(int dtype, int head_dim, const void* q,
                               const void* k, const void* v,
                               const int* lengths, void* out, int batch,
                               int hq, int hkv, int s, int s_cap,
                               cudaStream_t stream);

// q/out [B, Hq, D], k/v [B, S, Hkv, D], lengths [B] int32; keys at or past
// min(lengths[b], s_cap) are not read
void decode_attn(torch::Tensor q, torch::Tensor k, torch::Tensor v,
                 torch::Tensor lengths, int64_t s_cap, torch::Tensor out) {
  for (auto* t : {&q, &k, &v, &lengths, &out})
    TORCH_CHECK(t->is_cuda() && t->is_contiguous(),
                "decode_attn takes contiguous CUDA tensors");
  TORCH_CHECK(q.dim() == 3 && k.dim() == 4 && v.sizes() == k.sizes() &&
              out.sizes() == q.sizes() && k.size(3) == q.size(2));
  TORCH_CHECK(lengths.scalar_type() == torch::kInt32 &&
              lengths.numel() == q.size(0) && k.size(0) == q.size(0));
  TORCH_CHECK(k.scalar_type() == q.scalar_type() &&
              v.scalar_type() == q.scalar_type() &&
              out.scalar_type() == q.scalar_type());
  TORCH_CHECK(q.scalar_type() == torch::kFloat32 ||
                  q.scalar_type() == torch::kBFloat16,
              "decode_attn takes float32 or bfloat16, got ", q.scalar_type());
  const int dtype = q.scalar_type() == torch::kFloat32 ? 0 : 1;
  const c10::cuda::CUDAGuard guard(q.device());
  const cudaError_t err = decode_attn_launch(
      dtype, static_cast<int>(q.size(2)), q.data_ptr(), k.data_ptr(),
      v.data_ptr(), lengths.data_ptr<int>(), out.data_ptr(),
      static_cast<int>(q.size(0)), static_cast<int>(q.size(1)),
      static_cast<int>(k.size(2)), static_cast<int>(k.size(1)),
      static_cast<int>(s_cap), c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "decode_attn launch failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("decode_attn", &decode_attn, "dense-stripe GQA decode attention");
}
