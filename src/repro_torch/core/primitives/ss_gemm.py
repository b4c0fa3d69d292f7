"""Sparse skinny GEMM (paper §2.3.2, §4.2.4, §5.1.2/§5.2.2), functional part.

From :mod:`repro.core.primitives.ss_gemm`: ``C[M,N] = A[M,K] @ B[K,N]``
with A large and dense, B skinny (N in {2,4,8,16}) and dynamically sparse,
the DLRM small-batch inference regime.  The op that runs it on the card is
:func:`repro_torch.kernels.ss_gemm.ssgemm` (and its masked and compact
variants); this module holds the problem sizes, the oracle and the data.

The PIM-model half of the JAX module (``profile``, ``gpu_time_ns``,
``pim_stream``, ``pim_time``, ``speedups``) needs the timing simulator of
``repro.core`` and is not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

ELEM_BYTES = 2


@dataclasses.dataclass(frozen=True)
class Problem:
    m: int = 16384
    k: int = 4096
    n: int = 4
    density: float = 0.55       # per-element nonzero probability target
                                # (DLRM/Criteo-like multi-hot batches)


def reference(a: torch.Tensor, b: torch.Tensor, *,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The product in ``dtype`` (float32, as the JAX oracle's
    ``preferred_element_type``; float64 for a check of a float32 result)."""
    return torch.matmul(a.to(dtype), b.to(dtype))


def make_skinny(problem: Problem, seed: int = 0,
                dtype=np.float32) -> np.ndarray:
    """DLRM-like skinny matrix: row popularity is zipf-distributed (hot
    embedding rows recur across the batch), thinned to the target element
    density.  The JAX module's generator, draw for draw."""
    rng = np.random.default_rng(seed)
    k, n = problem.k, problem.n
    # Mild zipf row popularity, renormalized to the target mean density.
    rank = np.arange(1, k + 1, dtype=np.float64)
    rng.shuffle(rank)
    pop = 1.0 / rank ** 0.1
    pop *= problem.density * k / pop.sum()
    pop = np.clip(pop, 0.0, 1.0)
    mask = rng.random((k, n)) < pop[:, None]
    vals = rng.standard_normal((k, n))
    return (vals * mask).astype(dtype)


def measured_sparsity(b: np.ndarray) -> tuple[float, float]:
    """(element density, all-zero-row fraction) of a skinny matrix."""
    nz = b != 0
    density = float(nz.mean())
    row_zero = float((~nz.any(axis=1)).mean())
    return density, row_zero
