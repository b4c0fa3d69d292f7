"""Serving telemetry of the port, from :mod:`repro.serve.telemetry`,
copied: that module is framework-free, but the port imports nothing of
``repro``.  Two parts:

**MetricsRegistry**: the counters, gauges and fixed-bucket histograms that
the batcher's ``*_stats()`` views read.  Histograms keep their raw samples
beside the bucket counts (up to a reservoir cap), so
:meth:`MetricsRegistry.percentile` gives the same numbers as a percentile
over the plain sample list, and :meth:`MetricsRegistry.reset` is the one
place per-wave measurement state is cleared.  Names follow
``<subsystem>.<metric>[_<unit>]``, e.g. ``lat.ttft_s`` (histogram,
seconds) or ``join.chunk_continuations`` (counter).

**Tracer**: typed per-request lifecycle events

    SUBMIT -> ADMIT -> PREFILL_CHUNK x n -> FIRST_TOKEN
           -> SPEC_COMMIT x n -> (PREEMPT -> RESUME ->) ...
           -> RETIRE | CANCEL(reason=deadline|timeout|shed|client)

each stamped with the scheduling round, the slot, the pages that slot
holds and the pool's free pages, beside per-round scheduler spans (chaos
/ join / decode-segment / collect), control instants (DEGRADE, WATCHDOG),
chaos faults (``CHAOS_*``) and a pool-partition gauge sampled after every
allocator mutation (``KVPool.gauge_cb``).  :meth:`Tracer.timeline` gives
one request's events; :meth:`Tracer.to_perfetto` writes Chrome/Perfetto
``trace_event`` JSON (one track a slot, an async queue track, the
scheduler's spans and the pool's counters).  With ``ring=N`` the tracer is
a bounded flight recorder (the scheduler runs one always, and dumps its
tail when a page invariant trips or the watchdog fires).

Everything is host-side: the batcher calls in at its host sync points and
scheduling-round boundaries, never inside a decode segment (so never
inside a captured CUDA graph), and only behind ``if tracer is not None``.
"""
from __future__ import annotations

import json
import time
from collections import deque
from contextlib import contextmanager

import numpy as np


def _pct(a: list[float], q: float) -> float:
    """Percentile guarded against empty inputs — the single helper every
    stats method shares (0.0 on no samples, matching the rest of the
    reportable-either-way stats contract)."""
    return float(np.percentile(np.asarray(a), q)) if a else 0.0


# default histogram bounds (seconds): serving latencies from sub-ms host
# syncs to minute-scale drains.  Samples are kept raw alongside the bucket
# counts, so the bounds shape only the bucketed export, not percentiles.
DEFAULT_BUCKETS_S = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

# raw-sample reservoir cap: below this every observation is kept verbatim
# (so smoke/test-scale percentiles are bit-identical to the unbounded
# list); past it the reservoir decimates deterministically — a long drain
# no longer grows memory per observation.
DEFAULT_SAMPLE_CAP = 4096


class _Histogram:
    """Fixed-bucket histogram that also keeps a bounded raw reservoir.

    The bucket counts plus the running ``count`` / ``sum`` are the
    fixed-cost aggregates (exportable without the samples); the raw list
    is what the stats views' percentiles read.  Up to ``cap``
    observations the list is exact.  At ``cap`` the reservoir halves
    (every other sample dropped) and the keep-stride doubles, so a drain
    of any length holds at most ``cap`` floats while still covering the
    whole observation history at uniform (power-of-two) spacing.
    """

    __slots__ = ("bounds", "counts", "samples", "count", "sum",
                 "cap", "_stride", "_seen")

    def __init__(self, bounds: tuple[float, ...] = DEFAULT_BUCKETS_S,
                 cap: int = DEFAULT_SAMPLE_CAP):
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.samples: list[float] = []
        self.count = 0
        self.sum = 0.0
        self.cap = max(2, int(cap))
        self._stride = 1
        self._seen = 0

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        for i, b in enumerate(self.bounds):
            if v <= b:
                break
        else:
            i = len(self.bounds)
        self.counts[i] += 1
        self.count += 1
        self.sum += v
        if self._seen % self._stride == 0:
            self.samples.append(v)
            if len(self.samples) >= self.cap:
                del self.samples[1::2]       # deterministic decimation
                self._stride *= 2
        self._seen += 1

    def reset(self) -> None:
        self.counts = [0] * (len(self.bounds) + 1)
        self.samples.clear()                 # in place: stats views alias
        self.count = 0
        self.sum = 0.0
        self._stride = 1
        self._seen = 0


class MetricsRegistry:
    """Flat-namespace counters, gauges and histograms for the serving
    stack.  All host-side, all plain dicts: cheap enough to stay on in
    every run."""

    def __init__(self):
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, _Histogram] = {}

    # -- counters ------------------------------------------------------
    def inc(self, name: str, delta: float = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + delta

    def value(self, name: str) -> float:
        return self._counters.get(name, 0)

    # -- gauges --------------------------------------------------------
    def set_gauge(self, name: str, v: float) -> None:
        self._gauges[name] = v

    def gauge(self, name: str, default: float = 0.0) -> float:
        return self._gauges.get(name, default)

    # -- histograms ----------------------------------------------------
    def hist(self, name: str,
             bounds: tuple[float, ...] = DEFAULT_BUCKETS_S) -> _Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = _Histogram(bounds)
        return h

    def observe(self, name: str, v: float) -> None:
        self.hist(name).observe(v)

    def samples(self, name: str) -> list[float]:
        """The histogram's raw sample list (the live object)."""
        return self.hist(name).samples

    def count(self, name: str) -> int:
        """Total observations (running counter — survives reservoir
        decimation, costs nothing to read)."""
        return self.hist(name).count

    def sum(self, name: str) -> float:
        return float(self.hist(name).sum)

    def percentile(self, name: str, q: float) -> float:
        """Empty-guarded percentile over the raw samples: the one
        percentile implementation the stats views share."""
        return _pct(self.hist(name).samples, q)

    # -- lifecycle -----------------------------------------------------
    def reset(self, gauges: bool = False) -> None:
        """Zero every counter and histogram.  Gauges describe *current*
        state, not accumulation, so they survive by default — but a
        caller that is discarding the state they describe (the scheduler
        rebuilding its pool between waves) passes ``gauges=True`` so a
        stale geometry cannot leak into the next wave's ``snapshot()``.
        This is the whole per-wave measurement reset: a counter that
        lives here cannot be missed by ``reset_stats``."""
        self._counters.clear()
        for h in self._hists.values():
            h.reset()
        if gauges:
            self._gauges.clear()

    def clear_gauges(self, prefix: str) -> None:
        """Drop every gauge under ``prefix`` (e.g. ``"pool."`` when the
        pool that set them is torn down)."""
        for name in [n for n in self._gauges if n.startswith(prefix)]:
            del self._gauges[name]

    def snapshot(self) -> dict:
        """One flat dict of everything: counters verbatim, gauges under
        their name, histograms as ``name.count`` / ``name.sum`` /
        ``name.p50`` / ``name.p95`` (running aggregates — nothing is
        recomputed over raw lists here except the percentiles, which
        read the bounded reservoir)."""
        out: dict[str, float] = dict(self._counters)
        out.update(self._gauges)
        for name, h in self._hists.items():
            out[f"{name}.count"] = h.count
            out[f"{name}.sum"] = float(h.sum)
            out[f"{name}.p50"] = _pct(h.samples, 50)
            out[f"{name}.p95"] = _pct(h.samples, 95)
        return out


# typed lifecycle event kinds (the trace-completeness tests enumerate
# these — a new kind needs a track assignment in ``to_perfetto``).
# CANCEL is a terminal state like RETIRE: it closes the rid's queue span
# (a queued cancel) or its slot span (a mid-flight cancel) and carries a
# ``reason`` attr from repro_torch.serve.overload.CANCEL_REASONS.
LIFECYCLE_KINDS = ("SUBMIT", "ADMIT", "RESUME", "PREFILL_CHUNK",
                   "FIRST_TOKEN", "SPEC_COMMIT", "PREEMPT", "CANCEL",
                   "RETIRE")
# scheduler-global control-plane instants (rid=None -> scheduler track):
# DEGRADE marks a degradation-ladder transition, WATCHDOG a progress
# watchdog trip (flight bundle dumped, blocking head force-shed)
CONTROL_KINDS = ("DEGRADE", "WATCHDOG")
CHAOS_KINDS = ("CHAOS_HOLD", "CHAOS_RELEASE_HELD", "CHAOS_SLOT_FAILURE",
               "CHAOS_SLOT_FAILURE_NOOP", "CHAOS_VICTIM_OVERRIDE",
               "CHAOS_STALL", "CHAOS_BURST")

_PID = 1
_TID_SCHED = 0          # scheduler spans + chaos instants
_TID_QUEUE = 1          # async queue-residency spans
_TID_SLOT0 = 10         # slot s lands on tid _TID_SLOT0 + s


class Tracer:
    """Append-only event/span recorder for one batcher's lifetime.

    Everything is host-side and O(1) per call; the scheduler guards every
    call site with ``if tracer is not None`` so the off path costs
    nothing.  Timestamps are ``time.perf_counter()`` seconds relative to
    construction (``t0``); the Perfetto export converts to microseconds.

    ``ring=N`` turns the recorder into a bounded flight recorder: events,
    spans and pool samples live in ``deque(maxlen=...)`` ring buffers, so
    an arbitrarily long run holds at most the last N events — cheap
    enough to leave on even when full tracing is off.  The scheduler runs
    one such tracer unconditionally and dumps its tail as a debug bundle
    when a pool/prefix invariant trips (see ``Batcher.flight_bundle``).
    """

    def __init__(self, clock=time.perf_counter, ring: int | None = None):
        self._clock = clock
        self.t0 = clock()
        self.ring = ring
        if ring is None:
            self.events: list[dict] = []
            self.spans: list[dict] = []
            self.pool_samples: list[tuple[float, dict]] = []
        else:
            self.events = deque(maxlen=int(ring))
            self.spans = deque(maxlen=int(ring))
            self.pool_samples = deque(maxlen=int(ring))

    def now(self) -> float:
        return self._clock()

    # -- recording -----------------------------------------------------
    def event(self, kind: str, rid: int | None, *, round: int = 0,
              slot: int | None = None, pages_held: int = 0,
              pool_free: int = 0, t: float | None = None, **attrs) -> None:
        """One typed lifecycle/fault event.  ``rid=None`` marks a
        scheduler-global event (chaos faults); ``slot=None`` marks a
        queue-side event (SUBMIT, or ADMIT in dense mode where there is
        no pool)."""
        e = {"t": self._clock() if t is None else t, "kind": kind,
             "rid": rid, "round": round, "slot": slot,
             "pages_held": pages_held, "pool_free": pool_free}
        if attrs:
            e.update(attrs)
        self.events.append(e)

    def add_span(self, name: str, round: int, t0: float, t1: float) -> None:
        self.spans.append({"name": name, "round": round,
                           "t0": t0, "t1": max(t0, t1)})

    @contextmanager
    def span(self, name: str, round: int = 0):
        t0 = self._clock()
        try:
            yield
        finally:
            self.add_span(name, round, t0, self._clock())

    def pool_gauge(self, counts: dict) -> None:
        """Pool-partition sample (called from ``KVPool.gauge_cb`` after
        every allocator mutation)."""
        self.pool_samples.append((self._clock(), dict(counts)))

    def tail(self) -> list[dict]:
        """The retained events, oldest first, as plain copies — the
        flight-recorder bundle payload (for an unbounded tracer this is
        simply every event)."""
        return [dict(e) for e in self.events]

    # -- plain export --------------------------------------------------
    def rids(self) -> list[int]:
        seen = []
        for e in self.events:
            if e["rid"] is not None and e["rid"] not in seen:
                seen.append(e["rid"])
        return seen

    def timeline(self, rid: int) -> list[dict]:
        """The request's events in time order (copies — callers may
        annotate without corrupting the trace)."""
        return sorted((dict(e) for e in self.events if e["rid"] == rid),
                      key=lambda e: e["t"])

    def timelines(self) -> dict[int, list[dict]]:
        return {rid: self.timeline(rid) for rid in self.rids()}

    # -- Perfetto export -----------------------------------------------
    def _us(self, t: float) -> float:
        return max(0.0, (t - self.t0) * 1e6)

    def to_perfetto(self, path: str | None = None) -> dict:
        """Chrome/Perfetto ``trace_event`` JSON (load the file at
        https://ui.perfetto.dev or chrome://tracing).

        Track layout (one process, pid 1):

        * tid 0 ``scheduler`` — per-round spans (``ph:"X"``: chaos /
          join / decode-segment / collect, strictly sequential) plus
          chaos fault instants;
        * tid 1 ``queue`` — async spans (``ph:"b"``/``"e"``, id = rid)
          from SUBMIT (or PREEMPT) to ADMIT — queue residency overlaps
          across requests, which is what the async phase exists for;
        * tid 10+s ``slot s`` — an ``X`` span per occupancy (derived
          ADMIT -> RETIRE/PREEMPT; a preempted slot's span *ends at* the
          PREEMPT instant, the rid's next ADMIT opens a span on whatever
          slot re-admits it) with the lifecycle instants (``ph:"i"``)
          on top — one request per slot at a time, so slot spans never
          overlap;
        * counter track ``kv_pool_pages`` (``ph:"C"``) — the pool's
          free/mapped/cached/preempted/held partition sizes over time.
        """
        ev: list[dict] = []
        ev.append({"ph": "M", "pid": _PID, "name": "process_name",
                   "args": {"name": "repro_torch.serve"}})

        def thread_meta(tid: int, name: str) -> None:
            ev.append({"ph": "M", "pid": _PID, "tid": tid,
                       "name": "thread_name", "args": {"name": name}})

        thread_meta(_TID_SCHED, "scheduler")
        thread_meta(_TID_QUEUE, "queue")
        for sp in self.spans:
            ev.append({"name": sp["name"], "cat": "scheduler", "ph": "X",
                       "pid": _PID, "tid": _TID_SCHED,
                       "ts": self._us(sp["t0"]),
                       "dur": self._us(sp["t1"]) - self._us(sp["t0"]),
                       "args": {"round": sp["round"]}})

        events = sorted(self.events, key=lambda e: e["t"])
        slots_seen: set[int] = set()
        open_queue: set[int] = set()        # rids with an open queue span
        open_slot: dict[int, dict] = {}     # slot -> {"rid", "t0"}
        t_end = self._us(events[-1]["t"]) if events else 0.0

        def close_slot(slot: int, ts: float, end_kind: str) -> None:
            sp = open_slot.pop(slot, None)
            if sp is None:
                return
            ev.append({"name": f"rid {sp['rid']}", "cat": "slot",
                       "ph": "X", "pid": _PID, "tid": _TID_SLOT0 + slot,
                       "ts": sp["t0"], "dur": max(0.0, ts - sp["t0"]),
                       "args": {"rid": sp["rid"], "end": end_kind}})

        for e in events:
            kind, rid, slot = e["kind"], e["rid"], e["slot"]
            ts = self._us(e["t"])
            args = {k: v for k, v in e.items()
                    if k not in ("t", "kind") and v is not None}
            if slot is not None:
                tid = _TID_SLOT0 + slot
                slots_seen.add(slot)
            elif rid is None:
                tid = _TID_SCHED
            else:
                tid = _TID_QUEUE
            ev.append({"name": kind, "cat": "lifecycle", "ph": "i",
                       "s": "t", "pid": _PID, "tid": tid, "ts": ts,
                       "args": args})
            if rid is not None:
                if kind in ("SUBMIT", "PREEMPT") and rid not in open_queue:
                    open_queue.add(rid)
                    ev.append({"name": f"queued rid {rid}", "cat": "queue",
                               "ph": "b", "id": rid, "pid": _PID,
                               "tid": _TID_QUEUE, "ts": ts, "args": args})
                elif (kind in ("ADMIT", "CANCEL") and rid in open_queue):
                    # ADMIT moves the request onto a slot; a queued
                    # CANCEL (deadline/timeout/shed before admission)
                    # ends its residency without one
                    open_queue.discard(rid)
                    ev.append({"name": f"queued rid {rid}", "cat": "queue",
                               "ph": "e", "id": rid, "pid": _PID,
                               "tid": _TID_QUEUE, "ts": ts, "args": {}})
            if slot is not None:
                if kind == "ADMIT":
                    close_slot(slot, ts, "lost")     # defensive: no-op
                    open_slot[slot] = {"rid": rid, "t0": ts}
                elif kind in ("PREEMPT", "RETIRE", "CANCEL"):
                    close_slot(slot, ts, kind)
        for slot in list(open_slot):
            close_slot(slot, t_end, "open")          # still live at export
        for slot in sorted(slots_seen):
            thread_meta(_TID_SLOT0 + slot, f"slot {slot}")

        for t, counts in self.pool_samples:
            ev.append({"name": "kv_pool_pages", "cat": "pool", "ph": "C",
                       "pid": _PID, "ts": self._us(t),
                       "args": {k: int(v) for k, v in counts.items()}})

        data = {"traceEvents": ev, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(data, f)
                f.write("\n")
        return data
