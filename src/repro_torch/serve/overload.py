"""Overload protection of the port's scheduler, from
:mod:`repro.serve.overload`, copied: that module is framework-free, but
the port imports nothing of ``repro``.

The scheduler owns the actions (cancellation, admission sizing, chunk
sizing, shedding); this module owns the policy:

* :func:`project_finish_s`: an optimistic remaining-latency estimate from
  the metrics registry's observed TTFT/TPOT means, which the scheduler's
  deadline sweep uses to cancel a request that can no longer meet its
  deadline even in the best case (its pages come back now, not at the
  doomed completion);
* :class:`DegradationController`: a hysteresis ladder (HEALTHY ->
  DEGRADED -> SHEDDING) driven by the windowed SLO burn rate and the
  pool-pressure gauge.  DEGRADED sheds speculation and shrinks the
  prefill chunk; SHEDDING also freezes optimistic slot growth (admission
  reverts to worst-case reservation) and sheds lowest-priority queued
  work with a retryable ``RETRY_AFTER`` rejection.  Degradation changes
  when and whether work runs, never its tokens;
* :class:`Watchdog`: a per-round progress monitor.  When the scheduler's
  progress fingerprint (joins, commits, retirements, preemptions,
  cancellations) has not moved for ``watchdog_rounds`` rounds while work
  exists, the scheduler dumps the flight bundle and force-sheds the
  blocking head instead of looping: the run finishes minus the shed
  request and ships its own postmortem.

Everything here is host policy over numbers the registry and the pool
already expose: no torch, no device work, no sync.
"""
from __future__ import annotations

import time

# terminal-cancellation reason codes (the CANCEL trace event carries one)
CANCEL_REASONS = ("deadline", "timeout", "shed", "client")

# retryable-rejection status a shed queued request is answered with
RETRY_AFTER = "RETRY_AFTER"

HEALTHY = "HEALTHY"
DEGRADED = "DEGRADED"
SHEDDING = "SHEDDING"
STATES = (HEALTHY, DEGRADED, SHEDDING)
_RUNG = {s: i for i, s in enumerate(STATES)}


class WatchdogStall(RuntimeError):
    """Named stall error for the flight bundle — never raised out of the
    run loop (the watchdog sheds instead), but the bundle's ``error``
    field should say *what* tripped, not a generic RuntimeError."""


def project_finish_s(metrics, remaining_tokens: int,
                     queued: bool) -> float | None:
    """Optimistic seconds-to-completion from the registry's observed
    means: a queued request still owes one TTFT (admission + prefill)
    plus ``remaining_tokens - 1`` decode steps; a decoding slot owes only
    its remaining budget at the mean TPOT.  Returns None while the means
    have no samples (never cancel on a guess) — and the estimate is
    deliberately optimistic (unloaded means, no queue-position term), so
    a projection miss means the deadline is *unreachable even in the
    best case*, the one situation where holding pages is pure waste."""
    n_tpot = metrics.count("lat.tpot_s")
    tpot = metrics.sum("lat.tpot_s") / n_tpot if n_tpot else None
    if queued:
        n_ttft = metrics.count("lat.ttft_s")
        if not n_ttft:
            return None
        ttft = metrics.sum("lat.ttft_s") / n_ttft
        return ttft + max(0, remaining_tokens - 1) * (tpot or 0.0)
    if tpot is None:
        return None
    return max(0, remaining_tokens) * tpot


class DegradationController:
    """Hysteresis ladder HEALTHY → DEGRADED → SHEDDING over two signals.

    Per scheduling round the scheduler feeds :meth:`observe` the current
    windowed SLO burn rate (max of TTFT/TPOT burn, from ``slo_stats``)
    and the pool pressure (:meth:`KVPool.pressure`: mapped + held
    fraction — pages no admission could be granted from).  Severity:

    * **2 (critical)** — burn ≥ ``shed_burn``, or the pool is at
      ``shed_pressure`` with work still queued (admission is starving);
    * **1 (hot)** — burn ≥ ``degrade_burn`` or pressure ≥
      ``degrade_pressure``;
    * **0 (cool)** — neither.

    The ladder climbs one rung after ``up_rounds`` *consecutive* rounds
    of severity above the current rung and descends one rung after
    ``down_rounds`` consecutive rounds below it (asymmetric hysteresis:
    react fast, recover deliberately, never flap on one noisy sample).
    What each rung means is exposed as the ``shed_speculation`` /
    ``shrink_chunk`` / ``freeze_growth`` / ``shedding`` properties the
    scheduler consults; the controller never touches scheduler state.
    """

    def __init__(self, *, degrade_burn: float = 1.0,
                 shed_burn: float = 2.0,
                 degrade_pressure: float = 0.9,
                 shed_pressure: float = 1.0,
                 up_rounds: int = 2, down_rounds: int = 4,
                 clock=time.perf_counter):
        if up_rounds < 1 or down_rounds < 1:
            raise ValueError("hysteresis rounds must be >= 1")
        if not (0.0 < degrade_burn <= shed_burn):
            raise ValueError("need 0 < degrade_burn <= shed_burn")
        if not (0.0 < degrade_pressure <= shed_pressure <= 1.0):
            raise ValueError(
                "need 0 < degrade_pressure <= shed_pressure <= 1")
        self.degrade_burn = degrade_burn
        self.shed_burn = shed_burn
        self.degrade_pressure = degrade_pressure
        self.shed_pressure = shed_pressure
        self.up_rounds = up_rounds
        self.down_rounds = down_rounds
        self._clock = clock
        self.state = HEALTHY
        self._since = clock()
        self._hot = 0
        self._cool = 0
        self.time_in_state = {s: 0.0 for s in STATES}
        # (round, from_state, to_state, burn, pressure)
        self.transitions: list[tuple[int, str, str, float, float]] = []
        self.recovered_to_healthy = False

    # -- rung semantics (what the scheduler consults) -------------------
    @property
    def shed_speculation(self) -> bool:
        return self.state != HEALTHY

    @property
    def shrink_chunk(self) -> bool:
        return self.state != HEALTHY

    @property
    def freeze_growth(self) -> bool:
        return self.state == SHEDDING

    @property
    def shedding(self) -> bool:
        return self.state == SHEDDING

    # -- state machine --------------------------------------------------
    def severity(self, burn: float, pressure: float,
                 queue_depth: int) -> int:
        if (burn >= self.shed_burn
                or (pressure >= self.shed_pressure and queue_depth > 0)):
            return 2
        if burn >= self.degrade_burn or pressure >= self.degrade_pressure:
            return 1
        return 0

    def observe(self, *, burn: float, pressure: float, queue_depth: int,
                round: int = 0, now: float | None = None) -> str:
        """Feed one round's signals; returns the (possibly new) state."""
        now = self._clock() if now is None else now
        sev = self.severity(burn, pressure, queue_depth)
        rung = _RUNG[self.state]
        if sev > rung:
            self._hot += 1
            self._cool = 0
            if self._hot >= self.up_rounds:
                self._transition(STATES[rung + 1], round, now,
                                 burn, pressure)
                self._hot = 0
        elif sev < rung:
            self._cool += 1
            self._hot = 0
            if self._cool >= self.down_rounds:
                self._transition(STATES[rung - 1], round, now,
                                 burn, pressure)
                self._cool = 0
        else:
            self._hot = self._cool = 0
        return self.state

    def _transition(self, to: str, round: int, now: float,
                    burn: float, pressure: float) -> None:
        self.time_in_state[self.state] += max(0.0, now - self._since)
        self.transitions.append((round, self.state, to, burn, pressure))
        if to == HEALTHY and self.state != HEALTHY:
            self.recovered_to_healthy = True
        self.state = to
        self._since = now

    # -- reporting ------------------------------------------------------
    def stats(self, now: float | None = None) -> dict:
        """Time-in-state (with the open interval accrued to ``now``),
        the transition log, and the recovery flag the overload smoke
        gates on."""
        now = self._clock() if now is None else now
        tis = dict(self.time_in_state)
        tis[self.state] += max(0.0, now - self._since)
        return {"state": self.state,
                "time_in_state": tis,
                "transitions": list(self.transitions),
                "recovered_to_healthy": self.recovered_to_healthy}

    def reset(self) -> None:
        """Per-wave measurement reset (the scheduler's ``reset_stats``):
        zero the accumulated time-in-state / transition log / recovery
        flag but keep the *current* rung and hysteresis streaks — the
        controller describes live pressure, not history."""
        self._since = self._clock()
        self.time_in_state = {s: 0.0 for s in STATES}
        self.transitions.clear()
        self.recovered_to_healthy = False


class Watchdog:
    """Per-round progress monitor (replaces the idle-spin round counter).

    The scheduler feeds :meth:`tick` a progress *fingerprint* — a tuple
    of monotone counters (joins run, tokens committed, retirements,
    preemptions, cancellations) — once per scheduling round.  Any change
    is progress; ``limit`` consecutive unchanged rounds is a stall and
    ``tick`` returns True exactly once per trip (the counter re-arms, so
    a stall that survives the first shed trips again ``limit`` rounds
    later).  Pure bookkeeping: the scheduler owns the trip *action*
    (flight-bundle dump + force-shed)."""

    def __init__(self, limit: int):
        if limit < 1:
            raise ValueError("watchdog limit must be >= 1")
        self.limit = int(limit)
        self._last: tuple | None = None
        self.stalled_rounds = 0
        self.trips = 0

    def tick(self, fingerprint: tuple) -> bool:
        if fingerprint != self._last:
            self._last = fingerprint
            self.stalled_rounds = 0
            return False
        self.stalled_rounds += 1
        if self.stalled_rounds >= self.limit:
            self.trips += 1
            self.stalled_rounds = 0
            return True
        return False
