"""Fault injection for the port's scheduler, from :mod:`repro.serve.chaos`.

The port's copy, not an import: the JAX module is framework-free, but
importing it from ``repro.serve`` would pull in JAX.  The injected faults
are ones the scheduler is expected to *survive*:

* **forced pool exhaustion**: :meth:`KVPool.hold` takes free pages out of
  circulation at a configured scheduling round, so optimistic admission
  hits pool pressure (and must preempt) exactly when a test wants it to,
  through the real allocator path;
* **victim-selection override**: replaces the scheduler's (priority,
  most pages, least progress) policy for one decision;
* **simulated slot failure mid-decode**: a live slot's device state is
  declared lost at a configured round; the scheduler treats it as a
  preemption (release the pages, re-queue, recompute on resume);
* **forced stall**: suppress all scheduler work (no refill, no decode, no
  commits) for K rounds from a configured round, so the progress
  watchdog's trip (flight-bundle dump and force-shed of the blocking
  head) is exercised deterministically;
* **synthetic queue burst**: inject N low-priority requests into the
  queue at a configured round (optionally deadline-stamped), so the
  overload controller's pressure signal and shedding ladder see a
  reproducible spike mid-drain;
* **per-round invariant checks**: ``KVPool.check()`` (and
  ``PrefixCache.check()`` with the cache on) every scheduling round, so a
  violation surfaces at the round it happens.

Every action is keyed on the scheduler's round counter, so a run repeats,
and recorded in ``events``; with the batcher's tracer on, each also lands
in the trace as a ``CHAOS_*`` instant.  It is pure host code: the device
never sees it.

    chaos = ChaosInjector(exhaust_at={3: 0}, release_at=(6,),
                          check_invariants=True)
    b = Batcher(model, params, cfg, chaos=chaos)
"""
from __future__ import annotations

from typing import Callable, Iterable, Mapping


class ChaosInjector:
    """Deterministic, round-keyed fault injection for the scheduler.

    Parameters
    ----------
    exhaust_at:
        ``{round: keep_free}`` — at the given scheduling round, hold all
        but ``keep_free`` of the pool's free pages (``0`` = drain the
        free list completely).  Holds accumulate until released.
    release_at:
        rounds at which every held page is returned to the free list.
    fail_slot_at:
        ``{round: slot}`` — at the given round, declare the slot's
        device state lost.  ``slot`` may be an int index or ``"deepest"``
        (the live slot with the most resident tokens).  A round whose
        slot is not live records a no-op event instead of failing.
    victim_override:
        ``callable(batcher, candidates) -> slot | None`` consulted before
        the scheduler's victim policy; returning ``None`` falls through
        to the policy.
    stall_at:
        ``{round: k_rounds}`` — from the given round, the scheduler
        skips its entire round body (no refill, no decode segment, no
        commits, no retirements) for ``k_rounds`` consecutive rounds.
        A watchdog whose ``watchdog_rounds`` bound is below ``k_rounds``
        must trip during the stall (the watchdog's drill).
    burst_at:
        ``{round: n_requests}`` — inject ``n_requests`` synthetic
        low-priority (``burst_priority``) requests at the given round,
        each a deterministic short prompt sized to pass the scheduler's
        admission validation, stamped with ``burst_deadline_s`` when
        set.  Synthetic rids start at ``BURST_RID0`` so they can never
        collide with test workloads.
    check_invariants:
        run ``pool.check()`` / ``prefix.check()`` every round.
    """

    BURST_RID0 = 10_000

    def __init__(self, *,
                 exhaust_at: Mapping[int, int] | None = None,
                 release_at: Iterable[int] = (),
                 fail_slot_at: Mapping[int, int | str] | None = None,
                 victim_override: Callable | None = None,
                 stall_at: Mapping[int, int] | None = None,
                 burst_at: Mapping[int, int] | None = None,
                 burst_deadline_s: float | None = None,
                 burst_priority: int = -1,
                 check_invariants: bool = False):
        self.exhaust_at = dict(exhaust_at or {})
        self.release_at = set(release_at)
        self.fail_slot_at = dict(fail_slot_at or {})
        self.victim_override = victim_override
        self.stall_at = dict(stall_at or {})
        self.burst_at = dict(burst_at or {})
        self.burst_deadline_s = burst_deadline_s
        self.burst_priority = burst_priority
        self.check_invariants = check_invariants
        self.events: list[tuple[int, str, int]] = []   # (round, kind, arg)
        self.slot_failures = 0
        self._burst_seq = 0

    # ------------------------------------------------------------------
    def on_drain(self, batcher) -> None:
        """Called by the scheduler when a run drains.  Pages held for a
        release round the run did not reach are released now, recorded as
        that round's ``release_held`` at the drain's round: a scheduled
        release is never lost because the traffic finished first, so no
        page stays held past the run.  (JAX's injector keeps them held;
        its stress test fails on such runs.)"""
        pool = batcher.pool
        r = batcher.round
        if (pool is not None and pool.held_pages
                and any(at > r for at in self.release_at)):
            self.events.append((r, "release_held", pool.release_held()))

    def on_round(self, batcher) -> None:
        """Called by the scheduler at the top of every scheduling round
        (``batcher.round`` has already been advanced).  Every fault also
        lands in the batcher's trace (``CHAOS_*`` instants on the
        scheduler track) when telemetry is on, so a trace of a chaos run
        shows the injected cause next to the preemptions it forced."""
        r = batcher.round
        pool = batcher.pool
        tr = getattr(batcher, "telemetry", None)

        def trace(kind, **attrs):
            if tr is not None:
                tr.event(kind, None, round=r,
                         pool_free=pool.free_pages if pool else 0, **attrs)

        if pool is not None and r in self.release_at:
            released = pool.release_held()
            self.events.append((r, "release_held", released))
            trace("CHAOS_RELEASE_HELD", pages=released)
        if pool is not None and r in self.exhaust_at:
            keep = self.exhaust_at[r]
            taken = pool.hold(max(0, pool.free_pages - keep))
            self.events.append((r, "hold", len(taken)))
            trace("CHAOS_HOLD", pages=len(taken), keep_free=keep)
        if r in self.fail_slot_at:
            slot = self._resolve_slot(batcher, self.fail_slot_at[r])
            if slot is None:
                self.events.append((r, "fail_slot_noop", -1))
                trace("CHAOS_SLOT_FAILURE_NOOP")
            else:
                trace("CHAOS_SLOT_FAILURE", slot=slot)
                batcher._preempt_slot(slot, reason="slot-failure")
                self.slot_failures += 1
                self.events.append((r, "fail_slot", slot))
        if r in self.stall_at:
            k = max(1, int(self.stall_at[r]))
            # the scheduler checks ``round < _stall_until`` at the top of
            # each round and skips the whole round body — K dead rounds
            # with zero progress, exactly what the watchdog must catch
            batcher._stall_until = max(batcher._stall_until, r + k)
            self.events.append((r, "stall", k))
            trace("CHAOS_STALL", rounds=k)
        if r in self.burst_at:
            n = int(self.burst_at[r])
            for _ in range(n):
                rid = self.BURST_RID0 + self._burst_seq
                self._burst_seq += 1
                batcher.submit(rid, self._burst_prompt(batcher, rid),
                               priority=self.burst_priority,
                               deadline_s=self.burst_deadline_s)
            self.events.append((r, "burst", n))
            trace("CHAOS_BURST", requests=n)
        if self.check_invariants:
            if pool is not None:
                pool.check()
            if batcher.prefix is not None:
                batcher.prefix.check()

    def pick_victim(self, batcher, candidates: list[int]) -> int | None:
        """Victim-selection override hook: a non-None return replaces the
        scheduler's policy for this one decision."""
        if self.victim_override is None:
            return None
        v = self.victim_override(batcher, candidates)
        if v is not None:
            if v not in candidates:
                raise ValueError(f"chaos victim_override chose slot {v} "
                                 f"not in candidates {candidates}")
            self.events.append((batcher.round, "victim_override", v))
            tr = getattr(batcher, "telemetry", None)
            if tr is not None:
                tr.event("CHAOS_VICTIM_OVERRIDE", None,
                         round=batcher.round, slot=v)
        return v

    def _burst_prompt(self, batcher, rid: int) -> list[int]:
        """Deterministic synthetic prompt sized so the mid-run submit can
        never trip the scheduler's oversize validation (which only runs
        at ``run()`` entry): token ids stay tiny (< any real vocab) and
        the length fits ``max_len`` and the pool's per-slot page bound
        alongside the run's ``max_new`` budget + speculation window."""
        cfg = batcher.cfg
        budget = getattr(batcher, "_max_new", 16) + batcher.spec_k
        cap = cfg.max_len - budget
        if batcher.pool is not None:
            pool = batcher.pool
            cap = min(cap, min(pool.n_pages, pool.max_pages)
                      * pool.page_size - budget)
        plen = max(1, min(cfg.page_size if cfg.paged else 8, cap))
        return [1 + (rid * 7 + j) % 13 for j in range(plen)]

    @staticmethod
    def _resolve_slot(batcher, spec: int | str) -> int | None:
        live = [i for i, rid in enumerate(batcher.slot_rid)
                if rid is not None]
        if not live:
            return None
        if spec == "deepest":
            return max(live, key=lambda i: (batcher.slot_len[i], i))
        return spec if spec in live else None
