"""Reading a ``torch.profiler`` trace of a steady stretch of the window:
device busy time, idle gaps named by what the host was doing, and the
device time of the kernels whose names match a metric's patterns.

The profiler records every kernel a replayed CUDA graph runs, one by one,
as CUPTI reports them.  Device events are taken from ``prof.events()``
(kernels, copies and sets); their union over the stretch is the busy
time.  A gap between device events is named by the host span it falls
in: the benchmark records, on ``time.perf_counter``, the scheduler's own
spans (its tracer's ``join``, ``decode-segment`` and ``collect``) and its
client hook, and marks one instant on both clocks to map them onto the
trace.  Nothing is written to disk.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class DeviceEvent:
    name: str
    t0: float          # seconds on the perf_counter clock
    t1: float


@dataclasses.dataclass
class Stretch:
    """The traced stretch: [t0, t1] on the perf_counter clock, its device
    events and the host spans (name, t0, t1) that name its gaps."""
    t0: float
    t1: float
    events: list[DeviceEvent]
    host_spans: list[tuple[str, float, float]] = dataclasses.field(
        default_factory=list)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_s(self) -> float:
        """The union of the device events' intervals inside the stretch."""
        total, end = 0.0, self.t0
        for e in sorted(self.events, key=lambda e: e.t0):
            a, b = max(e.t0, end, self.t0), min(e.t1, self.t1)
            if b > a:
                total += b - a
            end = max(end, e.t1)
        return total

    def gaps(self) -> list[tuple[float, float]]:
        out, end = [], self.t0
        for e in sorted(self.events, key=lambda e: e.t0):
            if e.t0 > end:
                out.append((end, min(e.t0, self.t1)))
            end = max(end, e.t1)
        if end < self.t1:
            out.append((end, self.t1))
        return [(a, b) for a, b in out if b > a]

    def kernel_s(self, patterns: tuple[str, ...]) -> float:
        """Device seconds of the events whose name holds any pattern."""
        return sum(e.t1 - e.t0 for e in self.events
                   if any(p in e.name for p in patterns))

    def top_ops(self, n: int = 10) -> list[list]:
        by: dict[str, float] = {}
        for e in self.events:
            by[e.name] = by.get(e.name, 0.0) + (e.t1 - e.t0)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], sec] for name, sec in top]

    def idle_by_host(self, n: int = 10) -> list[list]:
        """Idle seconds summed by the host span each gap's midpoint falls
        in (the innermost one; ``host, no span`` outside them all)."""
        spans = sorted(self.host_spans, key=lambda s: s[2] - s[1])
        by: dict[str, float] = {}
        for a, b in self.gaps():
            mid = (a + b) / 2
            name = next((s[0] for s in spans if s[1] <= mid <= s[2]),
                        "host, no span")
            by[name] = by.get(name, 0.0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name, sec] for name, sec in top]


def device_events(prof, offset_s: float) -> list[DeviceEvent]:
    """The profile's device-side events on the perf_counter clock
    (``offset_s``: perf_counter seconds at the profiler's time 0)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.events():
        if e.device_type != cuda:
            continue
        tr = e.time_range
        out.append(DeviceEvent(e.name, offset_s + tr.start / 1e6,
                               offset_s + tr.end / 1e6))
    return out


def clock_offset(prof, mark_name: str, mark_t: float) -> float | None:
    """perf_counter seconds at the profiler's time 0, from the host event
    ``mark_name`` recorded at perf_counter ``mark_t``."""
    for e in prof.events():
        if e.name == mark_name:
            return mark_t - e.time_range.start / 1e6
    return None
