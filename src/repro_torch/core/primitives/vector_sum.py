"""vector-sum primitive (paper §3.2, §4.2.2), functional part.

From :mod:`repro.core.primitives.vector_sum`: elementwise ``c = a + b``
over fp16 arrays, the PIM "hello world".  The op that runs it on the card
is :func:`repro_torch.kernels.vector_sum.vector_sum`; this module holds the
problem size and the oracle.

The PIM-model half of the JAX module (``profile``, ``gpu_time_ns``,
``pim_stream``, ``pim_time``) needs the timing simulator of ``repro.core``
and is not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

ELEM_BYTES = 2  # fp16 (§2.3)


@dataclasses.dataclass(frozen=True)
class Problem:
    n: int  # elements per stack

    @property
    def bytes_per_array(self) -> int:
        return self.n * ELEM_BYTES


def reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b
