"""Data placement for PIM offload (paper §3.1.3/§3.1.4 + §4.2), a copy of
:mod:`repro.core.placement`.

Placement determines whether broadcast pim-commands are usable: interacting
operands must live in the same bank (operand locality) at the same row/col
address across banks (aligned data parallelism).  The descriptors here are
consumed by the per-primitive command-stream generators.
"""
from __future__ import annotations

import dataclasses
import math

from .hwspec import PimSpec


@dataclasses.dataclass(frozen=True)
class CoAligned:
    """Elementwise co-alignment (§4.2.2): element *i* of every structure maps
    to the same (bank, row, col).  ``structures`` arrays of ``n_bytes``."""

    n_bytes: int
    structures: int
    spec: PimSpec

    @property
    def bytes_per_pch(self) -> float:
        return self.n_bytes / self.spec.pch_per_stack

    @property
    def rows_per_bank(self) -> int:
        """DRAM rows one structure occupies in each bank of a pCH."""
        per_bank = self.bytes_per_pch / self.spec.banks_per_pch
        return max(1, math.ceil(per_bank / self.spec.row_buffer_bytes))

    @property
    def words_per_bank(self) -> int:
        per_bank = self.bytes_per_pch / self.spec.banks_per_pch
        return max(1, math.ceil(per_bank / self.spec.dram_word_bytes))


@dataclasses.dataclass(frozen=True)
class BlockedMatrix:
    """ss-gemm blocked format (paper Fig. 5).

    The dense matrix A[M, K] is laid out so one DRAM word holds 16
    contiguous-M fp16 values (SIMD dim), M blocks spread across banks and
    pCHs (aligned data parallelism), and K runs along columns within a row
    (row locality).  One bank row therefore holds a 16 x ``cols_per_row``
    (M x K) tile.
    """

    m: int
    k: int
    spec: PimSpec

    @property
    def m_per_bank(self) -> int:
        lanes = self.spec.simd_lanes
        return max(1, math.ceil(self.m / (lanes * self.spec.banks_per_stack)))

    @property
    def k_words_per_row(self) -> int:
        return self.spec.cols_per_row

    @property
    def rows_per_mblock(self) -> int:
        """DRAM rows holding all K for one 16-wide M block."""
        return max(1, math.ceil(self.k / self.k_words_per_row))

    @property
    def mblocks_per_bank(self) -> int:
        return self.m_per_bank


@dataclasses.dataclass(frozen=True)
class GridPlacement:
    """wavesim mesh placement (§4.2.3): a 3-D grid of elements is linearized
    so that neighbors along the two minor dimensions stay inside a bank and
    only the major dimension crosses banks (Fig. 4b).  ``cross_bank_frac``
    is the fraction of face interactions that land in different banks and
    therefore cannot be offloaded (they stay on the GPU)."""

    grid: tuple[int, int, int]
    elems_per_bank: int
    spec: PimSpec

    @property
    def n_elements(self) -> int:
        gx, gy, gz = self.grid
        return gx * gy * gz

    @property
    def cross_bank_frac(self) -> float:
        """Fraction of face interactions crossing a bank boundary when each
        bank holds a cubic sub-grid of ``elems_per_bank`` elements: the
        surface-to-face ratio 1/s for an s^3 cube (optimal placement)."""
        side = max(1.0, self.elems_per_bank ** (1.0 / 3.0))
        return min(1.0 / side, 0.5)


def grid_placement(grid: tuple[int, int, int], spec: PimSpec) -> GridPlacement:
    n = grid[0] * grid[1] * grid[2]
    per_bank = max(1, math.ceil(n / spec.banks_per_stack))
    return GridPlacement(grid=grid, elems_per_bank=per_bank, spec=spec)
