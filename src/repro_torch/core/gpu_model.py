"""GPU baseline analytical model (paper §4.3.1, "GPU Performance Model"),
a copy of :mod:`repro.core.gpu_model`: the paper's simulated GPU, not
the card the port runs on.

Execution time is a function of memory bandwidth (90% of peak) and the data
each primitive must move, assuming perfect on-chip reuse except:

* *wavesim*: no inter-timestep reuse (65K elements x 729 points x 2 B per
  GPU does not fit in cache);
* *push-primitive*: cache locality from measured L2 hit rates (44% / 20% /
  57% for the three graph inputs);
* *ss-gemm*: an **optimized** baseline that skips loading and computing on
  the all-zero rows of the skinny matrix (row-level sparsity).

Primitive modules compute their own byte counts and call :func:`time_ns`.
"""
from __future__ import annotations

import dataclasses

from .hwspec import GpuSpec


def time_ns(bytes_moved: float, spec: GpuSpec) -> float:
    """Bandwidth-bound execution time for ``bytes_moved`` DRAM bytes."""
    return bytes_moved / spec.effective_gbps


@dataclasses.dataclass(frozen=True)
class GpuEstimate:
    bytes_moved: float
    time_ns: float
    note: str = ""


def estimate(bytes_moved: float, spec: GpuSpec, note: str = "") -> GpuEstimate:
    return GpuEstimate(bytes_moved=bytes_moved,
                       time_ns=time_ns(bytes_moved, spec), note=note)


def cached_traffic(accesses: int, hit_rate: float, line_bytes: int) -> float:
    """DRAM bytes for ``accesses`` line-granular accesses under a cache with
    the given hit rate (misses fetch a full line; hits are free)."""
    return accesses * (1.0 - hit_rate) * line_bytes
