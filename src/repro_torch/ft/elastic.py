"""Fault tolerance: failure injection and straggler monitoring, copied
from :mod:`repro.ft.elastic`.

* :class:`FailureInjector`: a deterministic chaos hook for tests and the
  train driver; raises :class:`SimulatedFailure` at configured steps.
* :class:`StragglerMonitor`: a per-step wall-time tracker; flags steps
  slower than ``threshold`` x the trailing median and recommends eviction
  of persistently slow ranks.

Not ported: ``ElasticPlan``, which picks the largest (data, model) mesh a
checkpoint restores onto; it builds a mesh, and waits for the port's
sharding slice.
"""
from __future__ import annotations

import statistics
import time


class SimulatedFailure(RuntimeError):
    pass


class FailureInjector:
    def __init__(self, fail_at_steps: tuple[int, ...] = ()):
        self.fail_at = set(fail_at_steps)
        self.triggered: list[int] = []

    def check(self, step: int) -> None:
        if step in self.fail_at:
            self.fail_at.discard(step)
            self.triggered.append(step)
            raise SimulatedFailure(f"injected failure at step {step}")


class StragglerMonitor:
    def __init__(self, threshold: float = 1.5, window: int = 32):
        self.threshold = threshold
        self.window = window
        self.times: list[float] = []
        self.flags: list[int] = []
        self._t0: float | None = None

    def step_start(self) -> None:
        self._t0 = time.perf_counter()

    def step_end(self, step: int) -> bool:
        """Returns True if this step straggled."""
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        hist = self.times[-self.window:-1]
        if len(hist) >= 8:
            med = statistics.median(hist)
            if dt > self.threshold * med:
                self.flags.append(step)
                return True
        return False

    @property
    def straggle_rate(self) -> float:
        return len(self.flags) / max(1, len(self.times))

    def should_evict(self, recent: int = 16, max_flags: int = 4) -> bool:
        """Persistent straggling -> recommend rank eviction and a re-mesh
        (the driver acts on this)."""
        cutoff = max(0, len(self.times) - recent)
        return sum(1 for f in self.flags
                   if f >= cutoff) >= max_flags
