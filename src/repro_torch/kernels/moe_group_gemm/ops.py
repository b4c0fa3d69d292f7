"""Public grouped expert GEMM op, from
:mod:`repro.kernels.moe_group_gemm.ops`: float32 out, rows at or past each
expert's count exactly zero.

Routing is by the tensors' device and nothing else: a CUDA ``xe`` goes to
the hand-written kernel (:mod:`.kernel`), a CPU ``xe`` to its plain
version (:mod:`.ref`).  There is no fallback: a CUDA call the kernel
cannot take raises.  The JAX op's ``bc`` (capacity rows per tile) is not
taken: the result does not depend on it, and the kernel picks its own
tile (:func:`.kernel.tile_rows` x :func:`.kernel.tile_cols`) and needs no
padding of C.  There is no ``interpret`` flag.
"""
from __future__ import annotations

import torch

from . import kernel, ref


def group_gemm(xe: torch.Tensor, w: torch.Tensor,
               counts: torch.Tensor) -> torch.Tensor:
    """xe: [E, C, D], w: [E, D, F] (one dtype), counts: [E] -> [E, C, F]
    float32, ``xe[e] @ w[e]`` on the rows below ``counts[e]`` and zero on
    the rest."""
    if xe.dim() != 3 or w.dim() != 3 or w.shape[:2] != (xe.shape[0],
                                                          xe.shape[2]):
        raise ValueError(f"xe {tuple(xe.shape)} and w {tuple(w.shape)} "
                         "must be [E, C, D] and [E, D, F]")
    if xe.device.type == "cuda":
        return kernel.group_gemm_cuda(xe.contiguous(), w.contiguous(),
                                      counts.to(torch.int32).contiguous())
    return ref.group_gemm_ref(xe, w, counts)
