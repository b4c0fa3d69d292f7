"""Public vector-sum op, from :mod:`repro.kernels.vector_sum.ops`: any
shape, a + b in the inputs' dtype.

Routing is by the tensors' device and nothing else: CUDA tensors go to the
hand-written kernel (:mod:`.kernel`), CPU tensors to its plain version
(:mod:`.ref`).  There is no fallback: a CUDA call the kernel cannot take
raises.  The JAX op pads the flat length to rows of 512 lanes; the kernel
takes the flat length with its tail, so nothing is padded.  There is no
``interpret`` flag.
"""
from __future__ import annotations

import torch

from . import kernel, ref


def vector_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.shape != b.shape:
        raise ValueError("shape mismatch")
    if a.device.type == "cuda":
        return kernel.vector_sum_cuda(a.contiguous(), b.contiguous())
    return ref.vector_sum_ref(a, b)
