"""Sparse skinny GEMM (paper §2.3.2, §4.2.4, §5.1.2/§5.2.2), functional part.

From :mod:`repro.core.primitives.ss_gemm`: ``C[M,N] = A[M,K] @ B[K,N]``
with A large and dense, B skinny (N in {2,4,8,16}) and dynamically sparse,
the DLRM small-batch inference regime.  The op that runs it on the card is
:func:`repro_torch.kernels.ss_gemm.ssgemm` (and its masked and compact
variants); this module holds the problem sizes, the oracle, the data and
the paper's model of it.

Data placement (Fig. 5): A in the blocked format — 16 contiguous M values
per DRAM word (SIMD dim), M blocks across banks/pCHs, K along columns
within a row.  B values are broadcast as *immediate* operands on the data
bus; C partials accumulate in pim-registers (N accumulators) and are
written once per M-block.

Orchestration: per A-row (32 K-words), ``32*N`` broadcast MAC commands per
subset read A directly from the open row.  **Sparsity-aware** (§5.1.2): the
host inspects B[k, n] before issuing; zero values issue no command at all —
element-granular dynamic sparsity, no sparse format, no metadata.

GPU baseline (§4.3.1): optimized with *row-level* sparsity — all-zero rows
of B skip both loading A[:, k] and computing on it.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import gpu_model
from ..amenability import Interaction, PrimitiveProfile
from ..commands import Kind, Loop, Node, Seg, Subset
from ..hwspec import GpuSpec, PimSpec
from ..placement import BlockedMatrix
from ..timing import TimingStats, simulate

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


# ------------------------- amenability ------------------------------------

def profile(problem: Problem) -> PrimitiveProfile:
    ops = 2.0 * problem.m * problem.k * problem.n
    nbytes = ELEM_BYTES * (problem.m * problem.k + problem.k * problem.n
                           + problem.m * problem.n)
    return PrimitiveProfile(
        name=f"ss-gemm-N{problem.n}", ops=ops, mem_bytes=float(nbytes),
        onchip_bytes=1.0, interaction=Interaction.INDUCIBLE,
        alignable=True, input_dependent_locality=True,
        notes="blocked A layout induces locality (Fig. 5); N drives reuse",
    )


# ------------------------- GPU baseline -----------------------------------

def gpu_time_ns(problem: Problem, gpu: GpuSpec, row_zero_frac: float) -> float:
    a_bytes = problem.m * problem.k * ELEM_BYTES * (1.0 - row_zero_frac)
    b_bytes = problem.k * problem.n * ELEM_BYTES
    c_bytes = problem.m * problem.n * ELEM_BYTES
    return gpu_model.time_ns(a_bytes + b_bytes + c_bytes, gpu)


# ------------------------- PIM stream -------------------------------------

def pim_stream(problem: Problem, pim: PimSpec, *,
               sparsity_aware: bool = False,
               density: float | None = None) -> list[Node]:
    """Per-pCH stream.  Every bank walks its M-blocks; for each block the
    K loop visits ``rows_per_mblock`` A-rows with ``32*N`` (dense) or
    ``~32*N*density`` (sparsity-aware) MACs per row per subset, then writes
    the N accumulators to the C region (one row visit)."""
    place = BlockedMatrix(problem.m, problem.k, pim)
    d = problem.density if density is None else density
    macs_per_row = place.k_words_per_row * problem.n
    if sparsity_aware:
        macs_per_row = max(1, math.ceil(macs_per_row * d))
    k_rows = place.rows_per_mblock
    body: list[Node] = [
        Loop((Seg(Kind.ACT, Subset.ALL),
              Seg(Kind.PIM_BCAST, Subset.EVEN, macs_per_row),
              Seg(Kind.PIM_BCAST, Subset.ODD, macs_per_row)), k_rows),
        # C write-back: one row visit, N store commands per subset
        Seg(Kind.ACT, Subset.ALL),
        Seg(Kind.PIM_BCAST, Subset.EVEN, problem.n),
        Seg(Kind.PIM_BCAST, Subset.ODD, problem.n),
    ]
    return [Loop(tuple(body), place.mblocks_per_bank)]


def pim_time(problem: Problem, pim: PimSpec, *, sparsity_aware: bool = False,
             density: float | None = None) -> TimingStats:
    return simulate(pim_stream(problem, pim, sparsity_aware=sparsity_aware,
                               density=density), pim)


def speedups(problem: Problem, pim: PimSpec, gpu: GpuSpec,
             seed: int = 0) -> dict[str, float]:
    """Baseline and sparsity-aware PIM speedups with *measured* sparsity
    statistics from a generated skinny matrix (the GPU row-sparsity and the
    PIM element-sparsity come from the same data, as in the paper)."""
    b = make_skinny(problem, seed)
    density, row_zero = measured_sparsity(b)
    gpu_t = gpu_time_ns(problem, gpu, row_zero)
    base = gpu_t / pim_time(problem, pim).time_ns
    sa = gpu_t / pim_time(problem, pim, sparsity_aware=True,
                          density=density).time_ns
    return {"baseline": base, "sparsity_aware": sa,
            "density": density, "row_zero_frac": row_zero}
