"""vector-sum primitive (paper §3.2, §4.2.2), from
:mod:`repro.core.primitives.vector_sum`: elementwise ``c = a + b`` over
fp16 arrays, the PIM "hello world".  Amenability: op/byte 0.17, no reuse,
localized operand interaction, co-alignable -> highly PIM-amenable.

The op that runs it on the card is
:func:`repro_torch.kernels.vector_sum.vector_sum`; this module holds the
problem size, the oracle and the paper's model of it: the profile, the
GPU baseline and the PIM command stream.

Orchestration (§4.2.2): inputs/outputs co-aligned at allocation so element
*i* of a, b, c share a (bank, row, col).  Per register-sized chunk the
schedule visits three rows (a: pim-ld, b: pim-add, c: pim-st); pim-registers
stage data between row visits.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import gpu_model
from ..amenability import Interaction, PrimitiveProfile
from ..commands import Node
from ..hwspec import GpuSpec, PimSpec
from ..optimizations import Phase, chunk_cols, schedule
from ..placement import CoAligned
from ..timing import TimingStats, simulate

ELEM_BYTES = 2  # fp16 (§2.3)


@dataclasses.dataclass(frozen=True)
class Problem:
    n: int  # elements per stack

    @property
    def bytes_per_array(self) -> int:
        return self.n * ELEM_BYTES


def reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


# ------------------------- amenability ------------------------------------

def profile(problem: Problem) -> PrimitiveProfile:
    nbytes = 3 * problem.bytes_per_array
    return PrimitiveProfile(
        name="vector-sum",
        ops=float(problem.n),           # one add per element
        mem_bytes=float(nbytes),
        onchip_bytes=float(problem.n * ELEM_BYTES) * 0.0 + 1.0,  # ~none
        interaction=Interaction.LOCALIZED,
        alignable=True,
        notes="op/byte~0.17; co-align at allocation (§4.2.2)",
    )


# ------------------------- GPU baseline -----------------------------------

def gpu_time_ns(problem: Problem, gpu: GpuSpec) -> float:
    return gpu_model.time_ns(3.0 * problem.bytes_per_array, gpu)


# ------------------------- PIM stream -------------------------------------

def pim_stream(problem: Problem, pim: PimSpec, *, arch_aware: bool = False,
               regs: int | None = None) -> list[Node]:
    regs = regs or pim.pim_regs_per_alu
    place = CoAligned(n_bytes=problem.bytes_per_array, structures=3, spec=pim)
    cols = chunk_cols(regs)
    # One chunk: visit a-row (ld), b-row (add), c-row (st) — `cols` commands
    # per subset at each visit.
    phases = [Phase(cols), Phase(cols), Phase(cols)]
    trips = max(1, -(-place.words_per_bank // cols))
    return schedule(phases, trips, arch_aware)


def pim_time(problem: Problem, pim: PimSpec, *, arch_aware: bool = False,
             regs: int | None = None) -> TimingStats:
    return simulate(pim_stream(problem, pim, arch_aware=arch_aware,
                               regs=regs), pim)


def speedup(problem: Problem, pim: PimSpec, gpu: GpuSpec, *,
            arch_aware: bool = False, regs: int | None = None) -> float:
    return gpu_time_ns(problem, gpu) / pim_time(
        problem, pim, arch_aware=arch_aware, regs=regs).time_ns
