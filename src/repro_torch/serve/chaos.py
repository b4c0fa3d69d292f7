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
* **per-round invariant checks**: ``KVPool.check()`` (and
  ``PrefixCache.check()`` with the cache on) every scheduling round, so a
  violation surfaces at the round it happens.

JAX's injector also takes ``stall_at`` (the watchdog's drill) and
``burst_at`` (deadline-stamped synthetic overload); they come with the
port's overload slice, with the watchdog and deadlines they exercise, and
this constructor does not take them yet.  The port has no tracer, so the
injector records what it did in ``events`` only.

Every action is keyed on the scheduler's round counter, so a run repeats.
It is pure host code: the device never sees it.

    chaos = ChaosInjector(exhaust_at={3: 0}, release_at=(6,),
                          check_invariants=True)
    b = Batcher(model, params, cfg, chaos=chaos)
"""
from __future__ import annotations

from typing import Callable, Iterable, Mapping


class ChaosInjector:
    """Deterministic, round-keyed fault injection for the scheduler.

    ``exhaust_at``: ``{round: keep_free}``; at that scheduling round, hold
    all but ``keep_free`` of the pool's free pages (0 drains the free
    list).  Holds accumulate until released.

    ``release_at``: rounds at which every held page returns to the free
    list.

    ``fail_slot_at``: ``{round: slot}``; at that round, declare the slot's
    device state lost.  ``slot`` is an index or ``"deepest"`` (the live
    slot with the most resident tokens).  A round whose slot is not live
    records a no-op event instead.

    ``victim_override``: ``callable(batcher, candidates) -> slot | None``,
    consulted before the scheduler's victim policy; None falls through to
    the policy.

    ``check_invariants``: run ``pool.check()`` / ``prefix.check()`` every
    round."""

    def __init__(self, *,
                 exhaust_at: Mapping[int, int] | None = None,
                 release_at: Iterable[int] = (),
                 fail_slot_at: Mapping[int, int | str] | None = None,
                 victim_override: Callable | None = None,
                 check_invariants: bool = False):
        self.exhaust_at = dict(exhaust_at or {})
        self.release_at = set(release_at)
        self.fail_slot_at = dict(fail_slot_at or {})
        self.victim_override = victim_override
        self.check_invariants = check_invariants
        self.events: list[tuple[int, str, int]] = []   # (round, kind, arg)
        self.slot_failures = 0

    def on_round(self, batcher) -> None:
        """Called by the scheduler at the top of every scheduling round
        (``batcher.round`` already advanced)."""
        r = batcher.round
        pool = batcher.pool
        if pool is not None and r in self.release_at:
            self.events.append((r, "release_held", pool.release_held()))
        if pool is not None and r in self.exhaust_at:
            taken = pool.hold(max(0, pool.free_pages - self.exhaust_at[r]))
            self.events.append((r, "hold", len(taken)))
        if r in self.fail_slot_at:
            slot = self._resolve_slot(batcher, self.fail_slot_at[r])
            if slot is None:
                self.events.append((r, "fail_slot_noop", -1))
            else:
                batcher._preempt_slot(slot, reason="slot-failure")
                self.slot_failures += 1
                self.events.append((r, "fail_slot", slot))
        if self.check_invariants:
            if pool is not None:
                pool.check()
            if batcher.prefix is not None:
                batcher.prefix.check()

    def pick_victim(self, batcher, candidates: list[int]) -> int | None:
        """Victim-selection override: a non-None return replaces the
        scheduler's policy for this one decision."""
        if self.victim_override is None:
            return None
        v = self.victim_override(batcher, candidates)
        if v is not None:
            if v not in candidates:
                raise ValueError(f"chaos victim_override chose slot {v} "
                                 f"not in candidates {candidates}")
            self.events.append((batcher.round, "victim_override", v))
        return v

    @staticmethod
    def _resolve_slot(batcher, spec: int | str) -> int | None:
        live = [i for i, rid in enumerate(batcher.slot_rid)
                if rid is not None]
        if not live:
            return None
        if spec == "deepest":
            return max(live, key=lambda i: (batcher.slot_len[i], i))
        return spec if spec in live else None
