"""Plain PyTorch version of vector-sum, from
:mod:`repro.kernels.vector_sum.ref`: the CPU path of :mod:`.ops` and what
the CUDA kernel is held against on the card."""
from __future__ import annotations

import torch


def vector_sum_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b
