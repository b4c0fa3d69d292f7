"""Plain PyTorch version of the grouped expert GEMM, from
:mod:`repro.kernels.moe_group_gemm.ref`.

What the op runs on CPU tensors and what ``chip_smoke.py`` holds the CUDA
kernel against on the card: a float32 einsum per expert, with the rows at
or past each expert's count set to zero.
"""
from __future__ import annotations

import torch


def group_gemm_ref(xe: torch.Tensor, w: torch.Tensor,
                   counts: torch.Tensor) -> torch.Tensor:
    """xe: [E, C, D] expert token slabs (rows >= counts[e] are padding),
    w: [E, D, F] -> [E, C, F] float32; padded rows produce zeros."""
    y = torch.einsum("ecd,edf->ecf", xe.float(), w.float())
    c = xe.shape[1]
    live = (torch.arange(c, device=xe.device)[None, :, None]
            < counts.to(xe.device)[:, None, None])
    return torch.where(live, y, torch.zeros((), dtype=y.dtype,
                                            device=y.device))
