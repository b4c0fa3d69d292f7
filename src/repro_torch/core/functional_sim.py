"""Functional PIM simulator: *executes* broadcast command streams.  A
copy of :mod:`repro.core.functional_sim` (numpy, as there).

The timing engine (:mod:`.timing`) answers "how long"; this module
answers "does the orchestration compute the right thing".  It models the
strawman machine's visible state — per-bank DRAM rows, per-ALU register
files, an open-row buffer — and executes co-aligned elementwise programs
(the §4.2.2 class) command by command:

  ACT  (subset, row)        open a row in each bank of the subset
  LD   (subset, col, reg)   reg[bank] <- open_row[bank][col]
  OP   (subset, col, reg, fn) reg[bank] <- fn(reg[bank], open_row[bank][col])
  ST   (subset, col, reg)   open_row[bank][col] <- reg[bank] (write-through)

A program must respect the machine rules (registers per ALU, one open row
per bank, SIMD width) or the simulator raises — the same constraints the
paper's orchestration discussion is about.  Tests run the vector-sum
program produced by :func:`elementwise_program` against numpy oracles.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from .hwspec import PimSpec


@dataclasses.dataclass(frozen=True)
class Cmd:
    kind: str                  # act | ld | op | st
    subset: str                # even | odd | all (act only)
    row: int = 0               # act
    col: int = 0               # ld/op/st
    reg: int = 0
    fn: Callable | None = None


class PimMachine:
    """One pseudo-channel of the strawman machine.

    Command execution is vectorized over the target bank subset: DRAM rows
    are stored as one [banks, cols, lanes] array per row index, the even/odd
    bank index arrays are precomputed, and each broadcast command becomes a
    single masked NumPy gather/op/scatter over all its banks — the same
    visible semantics as a per-bank loop (one SIMD ALU per bank pair), ~10x
    faster for the functional-sim tests and PIM baselines.  ``fn`` for OP
    commands must therefore be elementwise (it receives [n_banks, lanes]
    blocks instead of one [lanes] vector at a time).
    """

    def __init__(self, spec: PimSpec | None = None):
        self.spec = spec or PimSpec()
        sp = self.spec
        self.lanes = sp.simd_lanes
        self.banks = sp.banks_per_pch
        self.cols = sp.cols_per_row
        self.mem: dict[int, np.ndarray] = {}   # row -> [banks, cols, lanes]
        # one ALU (register file) per bank *pair*
        self.regs = np.zeros((self.banks // 2, sp.pim_regs_per_alu,
                              self.lanes), np.float32)
        self._subset_idx = {
            "even": np.arange(0, self.banks, 2),
            "odd": np.arange(1, self.banks, 2),
            "all": np.arange(self.banks),
        }
        # ACT is the only way to open rows and always targets a whole
        # subset, so "which row is open" is one scalar per subset — the
        # single source of truth, and what lets compute commands use the
        # strided-view fast path.
        self._open = {"even": -1, "odd": -1}

    @property
    def open_row(self) -> np.ndarray:
        """Per-bank open-row view (derived; ACT keeps subsets uniform)."""
        out = np.empty((self.banks,), np.int64)
        out[0::2] = self._open["even"]
        out[1::2] = self._open["odd"]
        return out

    # ------------------------------------------------------------------
    def _row_store(self, row: int) -> np.ndarray:
        return self.mem.setdefault(
            row, np.zeros((self.banks, self.cols, self.lanes), np.float32))

    def write_row(self, bank: int, row: int, data: np.ndarray) -> None:
        assert data.shape == (self.cols, self.lanes)
        self._row_store(row)[bank] = data.astype(np.float32)

    def read_row(self, bank: int, row: int) -> np.ndarray:
        return self._row_store(row)[bank]

    def _banks(self, subset: str) -> np.ndarray:
        return self._subset_idx[subset]

    # ------------------------------------------------------------------
    def execute(self, program: Sequence[Cmd]) -> None:
        nregs = self.spec.pim_regs_per_alu
        regs = self.regs
        mem = self.mem
        opened = self._open
        for cmd in program:
            kind = cmd.kind
            if kind == "act":
                subset, row = cmd.subset, cmd.row
                if subset != "odd":
                    opened["even"] = row
                if subset != "even":
                    opened["odd"] = row
                continue
            subset = cmd.subset
            if subset == "all":
                raise ValueError("compute commands target even/odd subsets")
            if not 0 <= cmd.reg < nregs:
                raise ValueError(f"register {cmd.reg} out of range")
            row = opened[subset]
            start = 0 if subset == "even" else 1
            if row < 0:
                raise RuntimeError(f"bank {start}: no open row")
            buf = mem.get(row)
            if buf is None:
                buf = self._row_store(row)
            # strided views: subset banks are buf[start::2], and bank 2a /
            # 2a+1 share ALU a, so the subset's register lane is regs[:, r]
            block = buf[start::2, cmd.col]
            if kind == "ld":
                regs[:, cmd.reg] = block
            elif kind == "op":
                regs[:, cmd.reg] = cmd.fn(regs[:, cmd.reg], block)
            elif kind == "st":
                block[...] = regs[:, cmd.reg]   # write-through
            else:
                raise ValueError(kind)


# ---------------------------------------------------------------------------
# co-aligned elementwise programs (§4.2.2)
# ---------------------------------------------------------------------------

def place_coaligned(machine: PimMachine, arrays: dict[int, np.ndarray]):
    """Place equal-length arrays co-aligned: element i of every array in
    the same (bank, col, lane); array r lives in row r.  Returns the
    number of (col-chunk) iterations a program needs."""
    n = len(next(iter(arrays.values())))
    per_bank = machine.cols * machine.lanes
    need = machine.banks * per_bank
    if n > need:
        raise ValueError(f"array larger than one row-set ({need})")
    for row, arr in arrays.items():
        pad = np.zeros(need, np.float32)
        pad[:n] = arr
        machine._row_store(row)[:] = pad.reshape(
            machine.banks, machine.cols, machine.lanes)


def gather_coaligned(machine: PimMachine, row: int, n: int) -> np.ndarray:
    return machine._row_store(row).reshape(-1)[:n].copy()


def elementwise_program(spec: PimSpec, in_rows: Sequence[int], out_row: int,
                        fn: Callable, *, arch_aware: bool = False
                        ) -> list[Cmd]:
    """Generate the §4.2.2 schedule: per register-chunk, visit each input
    row (ld/op) then the output row (st), even/odd interleaved — the same
    phase structure the timing model charges for."""
    cols = spec.cols_per_row
    chunk = max(1, spec.pim_regs_per_alu // 2)
    program: list[Cmd] = []
    for c0 in range(0, cols, chunk):
        cspan = range(c0, min(c0 + chunk, cols))
        for phase, row in enumerate(list(in_rows) + [out_row]):
            program.append(Cmd("act", "all", row=row))
            for subset_i, subset in enumerate(("even", "odd")):
                for j, col in enumerate(cspan):
                    reg = subset_i * chunk + j
                    if phase == 0:
                        program.append(Cmd("ld", subset, col=col, reg=reg))
                    elif phase < len(in_rows):
                        program.append(Cmd("op", subset, col=col, reg=reg,
                                           fn=fn))
                    else:
                        program.append(Cmd("st", subset, col=col, reg=reg))
    return program
