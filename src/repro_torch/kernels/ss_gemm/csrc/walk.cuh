// The k-block walks of the skinny GEMM kernels (ss_gemm.cu, the CUDA-core
// walk, and ss_gemm_tc.cu, the tensor-core walk).  `steps()` blocks are
// visited; step j names block `block(j)`, or -1 to skip it.  Every thread of
// a CTA sees the same values.  A skipped block loads nothing of A or B.
#pragma once

#include <cuda_runtime.h>

namespace ss_gemm {

// `ssgemm_masked_kernel`'s walk: every k-block in order, the dead skipped.
struct MaskWalk {
  const int* mask;  // [nk] int32, nonzero where the block is live
  int nk;
  __device__ __forceinline__ int steps() const { return nk; }
  __device__ __forceinline__ int block(int j) const {
    return mask[j] != 0 ? j : -1;
  }
};

// `ssgemm_compact_kernel`'s walk: the listed blocks up to the live count,
// read from device memory (no host read); the TPU kernel's repeated tail is
// simply not walked.
struct ListWalk {
  const int* idx;     // [budget] int32 live block ids
  const int* n_live;  // [1] int32 entries of idx to walk
  int budget, nk;
  __device__ __forceinline__ int steps() const {
    return min(max(*n_live, 0), budget);
  }
  __device__ __forceinline__ int block(int j) const {
    const int kb = idx[j];
    return kb >= 0 && kb < nk ? kb : -1;  // never read out of bounds
  }
};

}  // namespace ss_gemm
