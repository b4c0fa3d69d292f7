"""Serving telemetry of the port, from :mod:`repro.serve.telemetry`,
copied: that module is framework-free, but the port imports nothing of
``repro``.  Two parts, and the port's device timing beside them:

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

**Device time and the port's inner spans.**  ``spans`` keeps JAX's
sequence of dicts: a bare :meth:`Tracer.add_span` or :meth:`Tracer.span`
gives exactly ``{name, round, t0, t1}``; the batcher's ``join`` and
``decode-segment`` add their device interval (``d0``, ``d1``) and the work
they did.  A second list, ``inner``, holds the port's own spans, each with
a stable ``id`` and its ``parent``'s: the ``round`` (parent of that
round's ``chaos``, ``join``, ``decode-segment`` and ``collect``, whose
ids and parents live in the side table ``span_links``), its ``sweep`` and
``admit``, and the model's parts inside a join (:mod:`repro_torch.parthook`).
With a ``device_timer`` (:class:`CudaTimer` on the card) a span that
enqueues device work takes a device mark at its start and its end; marks
become seconds on the tracer's own clock only at host syncs the batcher
already makes (:meth:`Tracer.device_sync`: the join's first-token read and
the segment's emitted-token read), against an anchor mark recorded on the
drained stream there beside a host stamp.  Without a timer (the CPU) no
span has ``d0``/``d1``.  :meth:`Tracer.summary` reduces a window of spans
to the join's and the segment's device times, the join's useful tokens,
its parts' shares, the scheduler's own time and the device's idle share.

Everything else is host-side: the batcher calls in at its host sync
points, scheduling-round boundaries and around the eager join's model
parts, never inside a decode segment (so never inside a captured CUDA
graph), and only behind ``if tracer is not None``.
"""
from __future__ import annotations

import itertools
import json
import math
import time
from collections import deque
from contextlib import contextmanager

import numpy as np
import torch

from .. import parthook


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
_TID_MODEL = 2          # the port's inner spans (rounds, sweeps, parts)
_TID_DEVICE = 3         # device intervals on the host clock
_TID_SLOT0 = 10         # slot s lands on tid _TID_SLOT0 + s

# the round's children that are not the scheduler's own time: the client
# hook at its top, the join and the decode segment
_NOT_SELF = ("chaos", "join", "decode-segment")


class CudaTimer:
    """Device marks for :class:`Tracer` on the card: a timing CUDA event
    recorded on the device's current stream.  ``seconds(a, b)`` is the
    device time from mark ``a`` to mark ``b`` (both complete),
    ``release(m)`` hands a mark whose time has been read back for reuse
    (making an event costs some 150 us of host time, recording a made one
    a few), and ``capturing()`` says whether that stream is capturing a
    CUDA graph, where no mark may be recorded."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._free: list = []

    def mark(self):
        ev = (self._free.pop() if self._free
              else torch.cuda.Event(enable_timing=True))
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def release(self, ev) -> None:
        self._free.append(ev)

    @staticmethod
    def seconds(a, b) -> float:
        return a.elapsed_time(b) * 1e-3

    @staticmethod
    def capturing() -> bool:
        return torch.cuda.is_current_stream_capturing()


def _gaps(t0: float, t1: float, busy: list[tuple[float, float]]
          ) -> list[tuple[float, float]]:
    """[t0, t1] less the union of the ``busy`` intervals."""
    out, at = [], t0
    for a, b in sorted(busy):
        if a > at:
            out.append((at, min(a, t1)))
        at = max(at, b)
        if at >= t1:
            break
    if at < t1:
        out.append((at, t1))
    return [(a, b) for a, b in out if b > a]


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

    ``device_timer`` (injectable as ``clock`` is; :class:`CudaTimer` on
    the card, None elsewhere) gives the spans that enqueue device work
    their device interval (``d0``, ``d1``: :meth:`mark`,
    :meth:`device_sync`).  Spans nest: :meth:`open` and :meth:`close`
    (and :meth:`add_span`) make the innermost open span the parent, held
    for ``spans`` in the side table ``span_links`` (``(id, parent)``, one
    a span) and in ``inner``'s own records.
    """

    def __init__(self, clock=time.perf_counter, ring: int | None = None,
                 device_timer=None):
        self._clock = clock
        self.t0 = clock()
        self.ring = ring
        self.device_timer = device_timer
        self._ids = itertools.count()
        # the open spans, innermost last: [id, parent id, record, inner?,
        # the records of its closed children]
        self._stack: list[list] = []
        # the last host sync's (anchor mark, host seconds), and the marks
        # not yet in seconds: (record, key, mark, anchor before it)
        self._anchor: tuple | None = None
        self._pending: list[tuple] = []
        # device counters (parthook.count): name -> [hits, total] int64 on
        # the counted tensors' device, added to in place, read by summary
        self.device_counts: dict[str, torch.Tensor] = {}
        if ring is None:
            self.events: list[dict] = []
            self.spans: list[dict] = []
            self.pool_samples: list[tuple[float, dict]] = []
            self.inner: list[dict] = []
            self.span_links: list[tuple[int, int | None]] = []
        else:
            self.events = deque(maxlen=int(ring))
            self.spans = deque(maxlen=int(ring))
            self.pool_samples = deque(maxlen=int(ring))
            self.inner = deque(maxlen=int(ring))
            self.span_links = deque(maxlen=int(ring))

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
        self._closed({"name": name, "round": round, "t0": t0,
                      "t1": max(t0, t1)}, next(self._ids), self._parent(),
                     inner=False)

    @contextmanager
    def span(self, name: str, round: int = 0):
        t0 = self._clock()
        try:
            yield
        finally:
            self.add_span(name, round, t0, self._clock())

    # -- nested spans and device intervals (the port's) ----------------
    def _parent(self) -> int | None:
        return self._stack[-1][0] if self._stack else None

    def _closed(self, rec: dict, sid: int, parent: int | None, *,
                inner: bool) -> None:
        if not inner:
            self.spans.append(rec)
            self.span_links.append((sid, parent))
        if self._stack:
            self._stack[-1][4].append(rec)

    def open(self, name: str, round: int = 0, *, inner: bool = False,
             t0: float | None = None) -> dict:
        """Open a span at ``t0`` (now) for :meth:`close` to end: one of
        ``spans`` (appended when it closes, as :meth:`add_span` appends)
        or, ``inner``, one of ``inner`` (appended now, with its ``id`` and
        its parent's).  The spans opened or added until it closes are its
        children."""
        sid, parent = next(self._ids), self._parent()
        rec = {"name": name, "round": round,
               "t0": self._clock() if t0 is None else t0, "t1": None}
        if inner:
            rec = {"id": sid, "parent": parent, **rec}
            self.inner.append(rec)
        self._stack.append([sid, parent, rec, inner, []])
        return rec

    def close(self, rec: dict, t1: float | None = None, **work
              ) -> list[dict]:
        """End the open span ``rec`` at ``t1`` (now) with the ``work``
        counts given, and return its children's records.  A span left
        open inside it leaves the open stack: a ``spans`` one unrecorded,
        an ``inner`` one with ``t1`` None."""
        t1 = self._clock() if t1 is None else t1
        while self._stack:
            sid, parent, top, inner, kids = self._stack.pop()
            if top is rec:
                break
        else:
            raise ValueError(f"span {rec.get('name')!r} is not open")
        rec["t1"] = max(rec["t0"], t1)
        rec.update(work)
        self._closed(rec, sid, parent, inner=inner)
        return kids

    @contextmanager
    def inner_span(self, name: str, round: int = 0):
        """An inner host span around the body (``sweep``, ``admit``)."""
        rec = self.open(name, round, inner=True)
        try:
            yield rec
        finally:
            self.close(rec)

    @contextmanager
    def round_span(self, round: int):
        """The ``round`` span around one scheduling round.  With a device
        timer it closes with ``idle_s``, its host interval less the union
        of its children's device intervals, and ``idle``, those seconds by
        the child span they fell in (``round`` between children), once
        every child's marks are seconds (a round traced before the first
        host sync goes without)."""
        rec = self.open("round", round, inner=True)
        try:
            yield rec
        finally:
            kids = self.close(rec)
            if self.device_timer is not None:
                self._note_idle(rec, kids)

    def _note_idle(self, rec: dict, kids: list[dict]) -> None:
        busy = []
        for k in kids:
            if "d0" in k:
                if k["d0"] is None or k.get("d1") is None:
                    return
                busy.append((k["d0"], k["d1"]))
        gaps = _gaps(rec["t0"], rec["t1"], busy)
        idle: dict[str, float] = {}
        for a, b in gaps:
            rest = b - a
            for k in kids:
                o = min(b, k["t1"]) - max(a, k["t0"])
                if o > 0:
                    idle[k["name"]] = idle.get(k["name"], 0.0) + o
                    rest -= o
            if rest > 0:
                idle["round"] = idle.get("round", 0.0) + rest
        rec["idle_s"] = sum(b - a for a, b in gaps)
        rec["idle"] = idle

    def count(self, name: str, hits, total) -> None:
        """The counter :mod:`repro_torch.parthook` arms around traced joins
        and decode segments: ``hits`` and ``total`` added in place to the
        device pair ``device_counts[name]``, with no read-back (made on the
        first count, an eager join's; a captured decode graph replays its
        adds)."""
        buf = self.device_counts.get(name)
        if buf is None:
            dev = hits.device if isinstance(hits, torch.Tensor) else None
            buf = self.device_counts[name] = torch.zeros(
                2, dtype=torch.int64, device=dev)
        buf[0].add_(hits)
        buf[1].add_(total)

    def part(self, name: str):
        """The recorder :mod:`repro_torch.parthook` arms around a traced
        join: an inner span of the model's part ``name``, a child of the
        innermost open span, with device marks; the hook's shared null
        context while the stream captures a CUDA graph."""
        dt = self.device_timer
        if dt is not None and dt.capturing():
            return parthook.NULL
        return self._part(name)

    @contextmanager
    def _part(self, name: str):
        rnd = self._stack[-1][2]["round"] if self._stack else 0
        with self.inner_span(name, rnd) as rec:
            self.mark(rec, "d0")
            try:
                yield rec
            finally:
                self.mark(rec, "d1")

    def mark(self, rec: dict, key: str) -> None:
        """A device mark for ``rec[key]`` (None until the next
        :meth:`device_sync` makes it seconds on this tracer's clock);
        nothing without a device timer."""
        dt = self.device_timer
        if dt is None:
            return
        rec[key] = None
        self._pending.append((rec, key, dt.mark(), self._anchor))

    def device_sync(self) -> None:
        """Called right after a host sync that drained the device's
        stream, so every pending mark is complete: each maps to the anchor
        recorded before it, ``host + seconds(anchor, mark)`` (a mark
        from before the first anchor maps back from that anchor at the
        next sync, when it is complete).  Then a new anchor is recorded
        on the drained stream and stamped with the host clock."""
        dt = self.device_timer
        if dt is None:
            return
        last, left = self._anchor, []
        for rec, key, ev, base in self._pending:
            if base is not None:
                rec[key] = base[1] + dt.seconds(base[0], ev)
            elif last is not None:
                rec[key] = last[1] - dt.seconds(ev, last[0])
            else:
                left.append((rec, key, ev, None))
                continue
            dt.release(ev)
        if last is not None:
            dt.release(last[0])
        self._pending = left
        self._anchor = (dt.mark(), self._clock())

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
          free/mapped/cached/preempted/held partition sizes over time;
        * with a device timer only (the card; a CPU trace is JAX's, event
          for event): tid 2 ``model`` — the port's inner spans nested by
          host time: each ``round`` (its idle seconds in its args), its
          ``sweep`` and ``admit``, and a join's parts; tid 3 ``device`` —
          the device intervals on the host clock: joins, decode segments
          and, nested in a join's, its parts'.
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
                       "args": {k: v for k, v in sp.items()
                                if k not in ("name", "t0", "t1")}})

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

        model = ([r for r in self.inner if r["t1"] is not None]
                 if self.device_timer is not None else [])
        if model:
            thread_meta(_TID_MODEL, "model")
        for r in model:
            ev.append({"name": r["name"], "cat": "model", "ph": "X",
                       "pid": _PID, "tid": _TID_MODEL,
                       "ts": self._us(r["t0"]),
                       "dur": self._us(r["t1"]) - self._us(r["t0"]),
                       "args": {k: v for k, v in r.items()
                                if k not in ("name", "t0", "t1", "d0",
                                             "d1")}})
        device = [r for r in list(self.spans) + model
                  if r.get("d0") is not None and r.get("d1") is not None
                  and self.device_timer is not None]
        if device:
            thread_meta(_TID_DEVICE, "device")
        for r in device:
            ev.append({"name": r["name"], "cat": "device", "ph": "X",
                       "pid": _PID, "tid": _TID_DEVICE,
                       "ts": self._us(r["d0"]),
                       "dur": max(0.0, self._us(r["d1"]) - self._us(r["d0"])),
                       "args": {"round": r["round"]}})

        data = {"traceEvents": ev, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(data, f)
                f.write("\n")
        return data

    # -- device-side summary -------------------------------------------
    def summary(self, t0: float | None = None,
                t1: float | None = None) -> dict:
        """The device-side measures of the spans that start in [t0, t1)
        (default: every span), each None where there is nothing to read
        (no device timer, no such span):

        - ``join.device_ms_mean``: the joins' mean device interval, ms;
        - ``join.useful_token_share``: the joins' prompt tokens
          (``real_tokens``) over the tokens they computed (``rows`` x
          ``width``), %;
        - ``parts``: each part's device seconds over the joins', % (a
          nested part, ``attn.core``, counts inside its parent's share
          too), and ``join.parts_share``: the top-level parts' sum, %;
        - ``moe.dispatch_share`` and ``join.attn_share``: ``parts``'
          ``moe.dispatch`` and ``attn.core``;
        - ``decode.device_step_ms``: the decode segments' device seconds
          over their steps, ms;
        - ``sched.round_self_ms``: the mean round less its ``chaos``,
          ``join`` and ``decode-segment`` children, ms;
        - ``moe.held_choice_share``: the routing choices that landed on
          the experts a chip's share holds over all choices, %, counted
          on the device over every traced join and decode step of the run
          (not only [t0, t1]); read back here, once;
        - ``idle_share``: the share of [t0, t1] (default: the rounds'
          extent) that no ``join`` or ``decode-segment`` device interval
          covers, %; the gaps inside those intervals (the host launching
          into an idle device) count busy, as does device work outside
          them (a cancelled row's latch), so a profiler's busy time reads
          it from the other side.
        """
        lo = float("-inf") if t0 is None else t0
        hi = float("inf") if t1 is None else t1

        def inside(r):
            return r["t1"] is not None and lo <= r["t0"] < hi

        def dev(r):
            d0, d1 = r.get("d0"), r.get("d1")
            return None if d0 is None or d1 is None else d1 - d0

        spans = list(self.spans)
        ids = {sid: r for (sid, _), r in zip(self.span_links, spans)}
        parent = {sid: p for sid, p in self.span_links}
        for r in self.inner:
            ids[r["id"]], parent[r["id"]] = r, r["parent"]
        joins = {sid: r for sid, r in ids.items()
                 if r["name"] == "join" and "id" not in r and inside(r)
                 and dev(r) is not None}
        join_dev = sum(dev(r) for r in joins.values())
        parts: dict[str, float] = {}
        top = 0.0
        for r in self.inner:
            at = r["parent"]
            while at is not None and at not in joins:
                at = parent.get(at)
            d = dev(r)
            if at is None or d is None:
                continue
            parts[r["name"]] = parts.get(r["name"], 0.0) + d
            if r["parent"] in joins:
                top += d
        computed = [r for r in spans if r["name"] == "join" and inside(r)
                    and "rows" in r]
        segs = [r for r in spans if r["name"] == "decode-segment"
                and inside(r) and dev(r) is not None and r.get("steps")]
        kids: dict[int, float] = {}
        for sid, r in ids.items():
            if "id" not in r and r["name"] in _NOT_SELF \
                    and parent.get(sid) is not None and r["t1"] is not None:
                kids[parent[sid]] = (kids.get(parent[sid], 0.0)
                                     + r["t1"] - r["t0"])
        rounds = [r for r in self.inner if r["name"] == "round"
                  and inside(r)]
        ends = [r for r in self.inner if r["name"] == "round"
                and r["t1"] is not None]
        w0 = min((r["t0"] for r in ends), default=lo) if t0 is None else t0
        w1 = max((r["t1"] for r in ends), default=hi) if t1 is None else t1
        busy = [(max(r["d0"], w0), min(r["d1"], w1)) for r in spans
                if dev(r) is not None and r["d1"] > w0 and r["d0"] < w1]

        def share(num, den):
            return 100.0 * num / den if den > 0 else None

        pct = {name: share(v, join_dev) for name, v in parts.items()}
        held = self.device_counts.get("moe.held_choice")
        held = held.tolist() if held is not None else (0, 0)
        return {
            "join.device_ms_mean": (join_dev / len(joins) * 1e3
                                    if joins else None),
            "join.useful_token_share": share(
                sum(r["real_tokens"] for r in computed),
                sum(r["rows"] * r["width"] for r in computed)),
            "parts": pct,
            "join.parts_share": share(top, join_dev) if parts else None,
            "moe.dispatch_share": pct.get("moe.dispatch"),
            "join.attn_share": pct.get("attn.core"),
            "moe.held_choice_share": share(*held),
            "decode.device_step_ms": (
                sum(dev(r) for r in segs) / sum(r["steps"] for r in segs)
                * 1e3 if segs else None),
            "sched.round_self_ms": (
                sum(r["t1"] - r["t0"] - kids.get(r["id"], 0.0)
                    for r in rounds) / len(rounds) * 1e3
                if rounds else None),
            "idle_share": (share(sum(b - a for a, b in _gaps(w0, w1, busy)),
                                 w1 - w0)
                           if busy and math.isfinite(w1 - w0) else None),
        }
