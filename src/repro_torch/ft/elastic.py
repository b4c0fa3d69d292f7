"""Fault tolerance: failure injection, elastic re-meshing and straggler
monitoring, from :mod:`repro.ft.elastic`.

* :class:`FailureInjector`: a deterministic chaos hook for tests and the
  train driver; raises :class:`SimulatedFailure` at configured steps.
* :class:`ElasticPlan`: given the surviving rank count, picks the largest
  (data, model) mesh a checkpoint restores onto (model axis preserved
  when possible, so parameter layouts survive; the data/FSDP axis
  shrinks) and builds it as a torch ``DeviceMesh``;
  ``Checkpointer.restore(template, shardings=)`` then places each leaf.
* :class:`StragglerMonitor`: a per-step wall-time tracker; flags steps
  slower than ``threshold`` x the trailing median and recommends eviction
  of persistently slow ranks.
"""
from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    data: int
    model: int
    pod: int = 1

    @property
    def n_devices(self) -> int:
        return self.data * self.model * self.pod

    @staticmethod
    def for_devices(n_available: int, *, model: int = 16,
                    prefer_pods: int = 1) -> "ElasticPlan":
        """Largest restorable mesh: keep the model axis (so parameter
        layouts survive), shrink pod first, then the data/FSDP axis."""
        for pod in range(prefer_pods, 0, -1):
            if n_available < model * pod:
                continue
            data = n_available // (model * pod)
            if data >= 1:
                return ElasticPlan(data=data, model=model, pod=pod)
        # degenerate: shrink model too (params re-layout on restore)
        m = model
        while m > 1 and n_available < m:
            m //= 2
        return ElasticPlan(data=max(1, n_available // m), model=m)

    def make_mesh(self):
        """The plan's ``DeviceMesh`` over the first ``n_devices`` ranks of
        the process group (``cuda`` under NCCL, else ``cpu``)."""
        from ..launch.mesh import _mesh
        if self.pod > 1:
            return _mesh((self.pod, self.data, self.model),
                         ("pod", "data", "model"))
        return _mesh((self.data, self.model), ("data", "model"))


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
