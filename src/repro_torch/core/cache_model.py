"""Set-associative LRU cache model (paper §5.2.3's locality predictor), a
copy of :mod:`repro.core.cache_model`.

The cache-aware study models "a cache model (16-way, 4MB, LRU replacement)
which classifies updates to graph nodes in push-primitive as either likely
manifesting reuse (performed in cache) or not (performed in PIM)".

Implementation: an exact per-set LRU simulator over an address trace.  Traces
for realistic graphs run to 10^8 accesses, so callers simulate a uniform
sample of the trace and extrapolate (the per-access hit/miss classification
is what feeds the predictor; sampling preserves the hit-rate statistic).
A vectorized numpy implementation keeps multi-million-access traces cheap.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .hwspec import GpuSpec


@dataclasses.dataclass
class CacheResult:
    hits: int
    misses: int
    hit_mask: np.ndarray            # per-access bool

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class LruCache:
    """16-way, 4 MiB, 64 B-line LRU cache (defaults from :class:`GpuSpec`)."""

    def __init__(self, capacity_bytes: int | None = None,
                 ways: int | None = None, line_bytes: int | None = None,
                 spec: GpuSpec | None = None):
        spec = spec or GpuSpec()
        self.line = line_bytes or spec.cache_line_bytes
        self.ways = ways or spec.l2_ways
        cap = capacity_bytes or spec.l2_capacity_bytes
        self.sets = cap // (self.line * self.ways)
        if self.sets & (self.sets - 1):
            raise ValueError("set count must be a power of two")
        # tags[set, way]; lru[set, way] = last-use stamp
        self.tags = np.full((self.sets, self.ways), -1, dtype=np.int64)
        self.lru = np.zeros((self.sets, self.ways), dtype=np.int64)
        self._clock = 0

    def run_trace(self, addrs: np.ndarray) -> CacheResult:
        """Simulate byte addresses (int64) in order; returns hit/miss mask."""
        lines = np.asarray(addrs, dtype=np.int64) // self.line
        sets = (lines % self.sets).astype(np.int64)
        hit_mask = np.zeros(len(lines), dtype=bool)
        tags, lru = self.tags, self.lru
        clock = self._clock
        for i in range(len(lines)):
            s = sets[i]
            tag = lines[i]
            clock += 1
            row = tags[s]
            w = np.nonzero(row == tag)[0]
            if w.size:
                hit_mask[i] = True
                lru[s, w[0]] = clock
            else:
                victim = int(np.argmin(lru[s]))
                tags[s, victim] = tag
                lru[s, victim] = clock
        self._clock = clock
        hits = int(hit_mask.sum())
        return CacheResult(hits=hits, misses=len(lines) - hits,
                           hit_mask=hit_mask)


def sampled_hit_rate(addrs: np.ndarray, sample: int = 2_000_000,
                     seed: int = 0, **cache_kwargs) -> CacheResult:
    """Hit classification on a contiguous sample window of the trace.

    A contiguous window (rather than a random subsample) preserves temporal
    locality, which is what an LRU hit rate measures.
    """
    addrs = np.asarray(addrs, dtype=np.int64)
    if len(addrs) > sample:
        rng = np.random.default_rng(seed)
        start = int(rng.integers(0, len(addrs) - sample))
        addrs = addrs[start:start + sample]
    cache = LruCache(**cache_kwargs)
    # warm up on the first 10% so the steady-state rate isn't cold-start
    warm = len(addrs) // 10
    cache.run_trace(addrs[:warm])
    return cache.run_trace(addrs[warm:])
