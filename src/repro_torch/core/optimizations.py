"""Schedule construction + the paper's three co-design optimizations (§5.1),
a copy of :mod:`repro.core.optimizations`.

Broadcast primitives execute as *row-group schedules*: a cyclic sequence of
phases, each phase being "switch to a row, then run N broadcast commands per
even/odd subset".  Two schedule flavors are generated:

* :func:`baseline_schedule` — Fig. 7a top: an **all-bank** activation on the
  critical path, followed by the even-subset then odd-subset compute
  commands of that phase.
* :func:`arch_aware_schedule` — Fig. 7a bottom (§5.1.1): activations are
  split per subset and issued *eagerly* so one subset activates while the
  other computes.  Compute order and per-subset dependencies are unchanged,
  so the schedule is functionally equivalent.

Register pressure shapes the phase structure: with ``R`` pim-registers per
ALU shared by a bank pair, a chunk processes ``R // 2`` columns per subset
before the schedule must revisit rows (§4.2.3's "considerable care ...
effectively utilize available registers").  More registers (the §5.1.4 limit
study) lengthen chunks, amortizing activations.

The sparsity-aware (§5.1.2) and cache-aware (§5.1.3) optimizations act on
command *counts* before schedule construction: sparsity thins the command
stream (commands for zero operands are never issued), and the cache split
routes reuse-heavy updates to the processor's cache.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from .commands import Kind, Loop, Node, Seg, Subset


@dataclasses.dataclass(frozen=True)
class Phase:
    """One row visit within a chunk: ``cmds`` broadcast commands/subset.

    ``serial`` marks a visit whose row contents depend on the immediately
    preceding compute (e.g. register spills): its activation cannot be
    issued eagerly, so even the architecture-aware schedule takes it on the
    critical path.
    """

    cmds_per_subset: int
    serial: bool = False


def chunk_cols(regs: int, pipelined: bool = True) -> int:
    """Columns a subset can process per chunk before register recycling.

    Registers are per-ALU and an ALU serves a bank *pair*; both baseline
    (even/odd interleaved after ACTab) and arch-aware (even/odd pipelined)
    schedules have both subsets' values live at once, so each subset gets
    ``regs // 2`` registers.
    """
    return max(1, regs // 2)


def baseline_schedule(phases: Sequence[Phase], trips: int) -> list[Node]:
    body: list[Node] = []
    for ph in phases:
        if ph.cmds_per_subset <= 0:
            continue
        body.append(Seg(Kind.ACT, Subset.ALL))
        body.append(Seg(Kind.PIM_BCAST, Subset.EVEN, ph.cmds_per_subset))
        body.append(Seg(Kind.PIM_BCAST, Subset.ODD, ph.cmds_per_subset))
    return [Loop(tuple(body), trips)]


def arch_aware_schedule(phases: Sequence[Phase], trips: int) -> list[Node]:
    """Decoupled even/odd activation (§5.1.1).

    The cyclic body interleaves: activate ODD's row for phase *p*, compute
    EVEN's phase *p* (whose row was activated one half-step earlier),
    activate EVEN's row for phase *p+1*, compute ODD's phase *p*.  Each
    activation overlaps the opposite subset's compute window; whether the
    latency is fully hidden depends on commands-per-phase (hence on register
    count) — exactly the paper's wavesim-flux observation.
    """
    body: list[Node] = []
    live = [ph for ph in phases if ph.cmds_per_subset > 0]
    for ph in live:
        if ph.serial:
            body.append(Seg(Kind.ACT, Subset.ALL))
            body.append(Seg(Kind.PIM_BCAST, Subset.EVEN, ph.cmds_per_subset))
            body.append(Seg(Kind.PIM_BCAST, Subset.ODD, ph.cmds_per_subset))
        else:
            body.append(Seg(Kind.ACT, Subset.ODD))
            body.append(Seg(Kind.PIM_BCAST, Subset.EVEN, ph.cmds_per_subset))
            body.append(Seg(Kind.ACT, Subset.EVEN))
            body.append(Seg(Kind.PIM_BCAST, Subset.ODD, ph.cmds_per_subset))
    return [Loop(tuple(body), trips)]


def schedule(phases: Sequence[Phase], trips: int,
             arch_aware: bool) -> list[Node]:
    if arch_aware:
        return arch_aware_schedule(phases, trips)
    return baseline_schedule(phases, trips)


# ---------------------------------------------------------------------------
# §5.1.2 sparsity-aware: the host inspects operands and skips issuing
# commands whose multiplier is zero.  At stream level this thins command
# counts by the *element* sparsity — no format change, no metadata.
# ---------------------------------------------------------------------------

def sparsity_thin(cmds: int, density: float) -> int:
    """Commands surviving the host's zero-check."""
    if not 0.0 <= density <= 1.0:
        raise ValueError("density must be in [0, 1]")
    return int(math.ceil(cmds * density))


# ---------------------------------------------------------------------------
# §5.1.3 cache-aware: a locality predictor classifies each update as
# cache-resident (keep on the processor) or not (offload to PIM).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CacheSplit:
    hot: int     # updates predicted to hit in cache -> processor
    cold: int    # updates predicted to miss -> PIM

    @property
    def total(self) -> int:
        return self.hot + self.cold

    @property
    def hot_frac(self) -> float:
        return self.hot / self.total if self.total else 0.0


def cache_split(n_updates: int, predicted_hit_rate: float) -> CacheSplit:
    hot = int(round(n_updates * predicted_hit_rate))
    return CacheSplit(hot=hot, cold=n_updates - hot)
