"""Analytical PIM timing engine (paper §4.3.1, "PIM Performance Model"),
a copy of :mod:`repro.core.timing`: the same float64 arithmetic in the
same order, so every figure equals the JAX package's bit for bit.

The engine evaluates a loop-compressed pim-command stream
(:mod:`.commands`) against DRAM timing (:class:`PimSpec`) for one
pseudo-channel; primitives are data-parallel across pseudo-channels, so the
stream generators divide the problem by ``pch_per_stack`` and stack time
equals pCH time.

Semantics implemented (all from §2.2/§4.1/§4.3.1 of the paper):

* Broadcast (multi-bank) pim-commands issue **in order** at one per
  ``tCCDL`` — half the regular rate (footnote 3) — and cannot issue until
  the target even/odd bank-subset's row is open.  A blocked head-of-line
  command stalls everything behind it.
* ``ACT`` covers precharge+activate of a fresh row in all banks of its
  subset.  Precharge may not start until ``tRAS`` after that subset's
  previous activation; data is available ``tRP + tRCD`` later.  Issuing the
  ACT consumes one regular command slot (``tCCDS``); once issued, *younger
  commands to the other subset keep issuing* — this is what the
  architecture-aware schedule (§5.1.1) exploits by activating one subset
  while the other computes.
* Single-bank pim-commands are freely reorderable (§4.3.1) and are modeled
  in aggregate as the max of three throughput limits: command-bus slots
  (``tCCDS / command_bw_mult`` each — §5.1.4's limit-study knob applies to
  data-less commands such as pim-store), data-bus slots (``tCCDS`` per
  operand-carrying command), and per-bank row-activation throughput
  (``tRC / banks_per_pch`` per activating command).

Loops are evaluated in steady state: the body is simulated twice and the
per-trip delta of the second (warmed-up) iteration is extrapolated, which is
exact for cyclic schedules.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from .commands import Kind, Loop, Node, Seg, Subset
from .hwspec import PimSpec


@dataclasses.dataclass
class _State:
    t: float = 0.0                      # next free issue slot on the bus
    row_ready_even: float = 0.0         # when EVEN subset's open row is usable
    row_ready_odd: float = 0.0
    last_act_even: float = -1e18        # last ACT (for tRAS window)
    last_act_odd: float = -1e18

    def copy(self) -> "_State":
        return dataclasses.replace(self)


@dataclasses.dataclass
class TimingStats:
    """Execution-time breakdown for one pCH (== one stack, data-parallel)."""

    time_ns: float = 0.0
    act_stall_ns: float = 0.0           # compute head blocked on row-open
    bcast_issue_ns: float = 0.0         # broadcast command slots
    sb_time_ns: float = 0.0             # single-bank aggregate time
    n_cmds: int = 0
    n_acts: int = 0

    def add(self, other: "TimingStats", mult: float = 1.0) -> None:
        self.time_ns += mult * other.time_ns
        self.act_stall_ns += mult * other.act_stall_ns
        self.bcast_issue_ns += mult * other.bcast_issue_ns
        self.sb_time_ns += mult * other.sb_time_ns
        self.n_cmds += int(mult * other.n_cmds)
        self.n_acts += int(mult * other.n_acts)

    @property
    def act_stall_frac(self) -> float:
        return self.act_stall_ns / self.time_ns if self.time_ns else 0.0


class PimTimer:
    def __init__(self, spec: PimSpec):
        self.spec = spec

    # ------------------------------------------------------------------
    def simulate(self, stream: Sequence[Node]) -> TimingStats:
        state = _State()
        stats = TimingStats()
        self._run(list(stream), state, stats)
        stats.time_ns = state.t
        return stats

    # ------------------------------------------------------------------
    def _run(self, nodes: Sequence[Node], st: _State, stats: TimingStats) -> None:
        i = 0
        while i < len(nodes):
            node = nodes[i]
            if isinstance(node, Seg) and node.kind is Kind.PIM_SB:
                # Coalesce adjacent single-bank segments: they interleave
                # freely, so their three throughput limits combine.
                j = i
                segs = []
                while j < len(nodes) and isinstance(nodes[j], Seg) \
                        and nodes[j].kind is Kind.PIM_SB:
                    segs.append(nodes[j])
                    j += 1
                self._run_sb(segs, st, stats)
                i = j
            elif isinstance(node, Seg):
                self._run_seg(node, st, stats)
                i += 1
            else:
                self._run_loop(node, st, stats)
                i += 1

    # ------------------------------------------------------------------
    MAX_WARMUP = 8

    def _run_loop(self, loop: Loop, st: _State, stats: TimingStats) -> None:
        if loop.trips == 0:
            return
        if loop.trips <= 2:
            for _ in range(loop.trips):
                self._run(loop.body, st, stats)
            return
        # Warm up until the per-trip delta converges (tRAS window chains
        # can take a few trips to reach steady state), then extrapolate.
        done = 0
        prev_dt = None
        s_last = TimingStats()
        while done < min(self.MAX_WARMUP, loop.trips):
            before = st.copy()
            s_last = TimingStats()
            self._run(loop.body, st, s_last)
            s_last.time_ns = 0.0
            stats.add(s_last)
            done += 1
            dt = st.t - before.t
            if prev_dt is not None and abs(dt - prev_dt) < 1e-9:
                break
            prev_dt = dt
        remaining = loop.trips - done
        if remaining <= 0:
            return
        dt = st.t - before.t
        stats.add(s_last, mult=float(remaining))
        # advance the clock analytically; bank windows shift with it
        shift = dt * remaining
        st.t += shift
        st.row_ready_even += shift
        st.row_ready_odd += shift
        st.last_act_even += shift
        st.last_act_odd += shift

    # ------------------------------------------------------------------
    def _run_seg(self, seg: Seg, st: _State, stats: TimingStats) -> None:
        sp = self.spec
        if seg.kind is Kind.ACT:
            for _ in range(seg.count):
                self._activate(seg.subset, st)
            stats.n_acts += seg.count
            stats.n_cmds += seg.count
        elif seg.kind is Kind.PIM_BCAST:
            ready = (st.row_ready_even if seg.subset is Subset.EVEN
                     else st.row_ready_odd)
            # first command of the run may stall on the row; the rest stream
            start = max(st.t, ready)
            stall = start - st.t
            st.t = start + seg.count * sp.t_ccdl_ns
            stats.act_stall_ns += stall
            stats.bcast_issue_ns += seg.count * sp.t_ccdl_ns
            stats.n_cmds += seg.count
        elif seg.kind in (Kind.RD, Kind.WR):
            st.t += seg.count * sp.t_ccds_ns
            stats.n_cmds += seg.count
        else:  # pragma: no cover - PIM_SB handled by _run_sb
            raise AssertionError(seg.kind)

    # ------------------------------------------------------------------
    def _activate(self, subset: Subset, st: _State) -> None:
        sp = self.spec
        issue = st.t
        st.t = issue + sp.t_ccds_ns   # the ACT command's bus slot
        subsets = ([Subset.EVEN, Subset.ODD] if subset is Subset.ALL
                   else [subset])
        for s in subsets:
            last = st.last_act_even if s is Subset.EVEN else st.last_act_odd
            pre_start = max(issue, last + sp.t_ras_ns)
            ready = pre_start + sp.t_rp_ns + sp.t_rcd_ns
            act_t = pre_start + sp.t_rp_ns
            if s is Subset.EVEN:
                st.row_ready_even, st.last_act_even = ready, act_t
            else:
                st.row_ready_odd, st.last_act_odd = ready, act_t

    # ------------------------------------------------------------------
    def _run_sb(self, segs: Sequence[Seg], st: _State,
                stats: TimingStats) -> None:
        """Aggregate model for freely-reorderable single-bank commands."""
        sp = self.spec
        cmd_slots = 0.0     # command-bus occupancy (ns)
        data_slots = 0.0    # data-bus occupancy (ns)
        act_work = 0.0      # row-activation work (ns of bank-time)
        n = 0
        for seg in segs:
            n += seg.count
            cmd_slots += seg.count * sp.t_ccds_ns / sp.command_bw_mult
            if seg.carries_data:
                data_slots += seg.count * sp.t_ccds_ns
            act_work += (seg.count * (1.0 - seg.row_hit_frac)
                         * sp.row_cycle_ns / sp.banks_per_pch)
        dur = max(cmd_slots, data_slots, act_work)
        st.t += dur
        stats.sb_time_ns += dur
        stats.n_cmds += n


def simulate(stream: Sequence[Node], spec: PimSpec | None = None) -> TimingStats:
    return PimTimer(spec or PimSpec()).simulate(stream)
