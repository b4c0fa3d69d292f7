"""pim-command intermediate representation, a copy of
:mod:`repro.core.commands` (the port imports nothing of ``repro``).

The paper's execution model (§4.1): a *pim-kernel* issues *pim-instructions*
which become *pim-commands* enqueued at the memory controller.  Broadcast
(multi-bank) commands execute the same operation on every bank of an even or
odd subset of a pseudo-channel and are issued **in FIFO order** at half the
regular column-command rate (tCCDL, footnote 3).  Single-bank commands can be
freely reordered and issue at the regular rate (tCCDS).

Real streams for realistic problem sizes contain billions of commands, so the
IR is *loop-compressed*: a stream is a list of :class:`Seg` segments, each a
run of ``count`` identical-cost commands, wrapped into :class:`Loop` bodies
that the timing engine evaluates in steady state instead of unrolling.  This
keeps the analytical model exact for cyclic schedules while evaluating in
microseconds.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Iterable, Sequence, Union


class Kind(enum.Enum):
    # Row management.  ACT covers precharge+activate of a *new* row.
    ACT = "act"                 # activate a row in every bank of `subset`
    # Broadcast (multi-bank) compute / data-movement commands: one command
    # drives all PIM units of `subset` (8 banks).  Covers pim-ld (DRAM->reg),
    # pim-op reg op= DRAM/imm, pim-st (reg->DRAM): identical cost.
    PIM_BCAST = "pim_bcast"
    # Single-bank pim-commands (push-primitive style).  `carries_data` tells
    # whether the command moves an operand over the data bus (pim-ADD does,
    # pim-store does not — §5.2.3's command-bandwidth discussion).
    PIM_SB = "pim_sb"
    # Regular (non-PIM) column read/write, one bank, 32 B.
    RD = "rd"
    WR = "wr"


class Subset(enum.Enum):
    EVEN = "even"
    ODD = "odd"
    ALL = "all"    # ACT only: the baseline all-bank activation


@dataclasses.dataclass(frozen=True)
class Seg:
    """``count`` consecutive commands of one kind/subset.

    For ``Kind.ACT``, ``count`` is the number of successive *row switches*
    performed by this segment (each to a fresh row).
    """

    kind: Kind
    subset: Subset = Subset.ALL
    count: int = 1
    carries_data: bool = True     # PIM_SB only
    row_hit_frac: float = 0.0     # PIM_SB only: fraction needing no ACT

    def __post_init__(self) -> None:
        if self.count < 0:
            raise ValueError("negative segment count")
        if self.kind is Kind.PIM_BCAST and self.subset is Subset.ALL:
            raise ValueError("broadcast commands target an even/odd subset")


@dataclasses.dataclass(frozen=True)
class Loop:
    """``body`` repeated ``trips`` times (steady-state evaluated)."""

    body: Sequence["Node"]
    trips: int

    def __post_init__(self) -> None:
        if self.trips < 0:
            raise ValueError("negative trip count")


Node = Union[Seg, Loop]


def total_commands(nodes: Iterable[Node]) -> int:
    """Exact command count of a compressed stream (ACT counts as issued)."""
    n = 0
    for node in nodes:
        if isinstance(node, Seg):
            n += node.count
        else:
            n += node.trips * total_commands(node.body)
    return n


def total_by_kind(nodes: Iterable[Node]) -> dict[Kind, int]:
    out: dict[Kind, int] = {k: 0 for k in Kind}

    def rec(ns: Iterable[Node], mult: int) -> None:
        for node in ns:
            if isinstance(node, Seg):
                out[node.kind] += mult * node.count
            else:
                rec(node.body, mult * node.trips)

    rec(nodes, 1)
    return out


def flatten(nodes: Iterable[Node], max_commands: int = 2_000_000) -> list[Seg]:
    """Fully unroll a stream (tests / small problems only)."""
    out: list[Seg] = []

    def rec(ns: Iterable[Node]) -> None:
        for node in ns:
            if isinstance(node, Seg):
                out.append(node)
            else:
                for _ in range(node.trips):
                    rec(node.body)
            if sum(s.count for s in out) > max_commands:
                raise ValueError("stream too large to flatten")

    rec(nodes)
    return out
