"""Serving metrics of the port: the registry of counters, gauges and
fixed-bucket histograms that the batcher's ``*_stats()`` views read, from
:mod:`repro.serve.telemetry` (``MetricsRegistry``), copied: that module
is framework-free, but the port imports nothing of ``repro``.

Histograms keep their raw samples beside the bucket counts (up to a
reservoir cap), so :meth:`MetricsRegistry.percentile` gives the same
numbers as a percentile over the plain sample list, and
:meth:`MetricsRegistry.reset` is the one place per-wave measurement state
is cleared.  Names follow ``<subsystem>.<metric>[_<unit>]``, e.g.
``lat.ttft_s`` (histogram, seconds) or ``join.chunk_continuations``
(counter).  Everything is host-side: the batcher observes at its host
sync points, never inside a decode segment.  The JAX module's ``Tracer``
(per-request lifecycle events and Perfetto export) is not ported yet.
"""
from __future__ import annotations

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
