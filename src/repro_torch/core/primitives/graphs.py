"""Graph generators + traces for the push-primitive study (paper §4.3.1).

A copy of :mod:`repro.core.primitives.graphs` (numpy only; the port
imports nothing of ``repro``): the same seed gives the same arrays.

The paper evaluates three inputs with measured L2 hit rates:
  * roadnet-usa                  — hit rate 44% (low-degree, spatially local)
  * power-law 1M nodes/10M edges — hit rate 20%
  * power-law 10M/100M           — hit rate 57%

We model structurally-similar synthetic graphs.  Full edge lists for these
sizes are hundreds of MB, and the locality statistics only need a trace
*window*, so :class:`Graph` stores counts plus a lazy window generator: a
contiguous run of destination accesses in push-traversal (source) order.
The LRU cache model replays windows to classify per-update locality for the
cache-aware study; the paper's measured hit rates calibrate the GPU
baseline.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    name: str
    n_nodes: int
    n_edges: int
    measured_l2_hit: float     # paper's rocprof hit rate for the GPU model
    _window_fn: Callable[[int, int], np.ndarray]

    def trace_window(self, length: int, seed: int = 0) -> np.ndarray:
        """A contiguous window of destination-node accesses."""
        return self._window_fn(length, seed)

    def edges(self, length: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """(src, dst) arrays for a window — for the functional primitive."""
        rng = np.random.default_rng(seed + 7)
        dst = self.trace_window(length, seed)
        deg = max(1, self.n_edges // self.n_nodes)
        src = np.repeat(rng.integers(0, self.n_nodes, size=(len(dst) + deg - 1) // deg),
                        deg)[:len(dst)]
        return src.astype(np.int64), dst.astype(np.int64)


def powerlaw(n_nodes: int, n_edges: int, alpha: float = 1.2,
             name: str = "powerlaw", measured_l2_hit: float = 0.2,
             seed: int = 0) -> Graph:
    """Destination-preferential power-law graph: destination popularity is
    zipf-like; hot destinations recur throughout the trace (that recurrence
    is the cache's opportunity)."""
    base = np.random.default_rng(seed)
    perm_seed = int(base.integers(1 << 31))

    def window(length: int, wseed: int) -> np.ndarray:
        rng = np.random.default_rng((seed, wseed))
        # Draw zipf-distributed ranks via inverse-CDF on a truncated zipf.
        u = rng.random(length)
        if alpha == 1.0:
            ranks = np.exp(u * np.log(n_nodes))
        else:
            a = 1.0 - alpha
            ranks = ((n_nodes ** a - 1.0) * u + 1.0) ** (1.0 / a)
        ranks = np.clip(ranks.astype(np.int64), 1, n_nodes) - 1
        # decorrelate popularity from node index
        mix = np.random.default_rng(perm_seed)
        salt = int(mix.integers(1, n_nodes))
        return (ranks * salt + salt) % n_nodes

    return Graph(name=name, n_nodes=n_nodes, n_edges=n_edges,
                 measured_l2_hit=measured_l2_hit, _window_fn=window)


def roadnet(n_nodes: int, avg_degree: float = 2.4, far_frac: float = 0.42,
            name: str = "roadnet-usa", measured_l2_hit: float = 0.44,
            seed: int = 0) -> Graph:
    """Road-network-like graph: low degree, most neighbors index-local
    (spatial renumbering) with a long-range remainder (highways / imperfect
    renumbering), traversal sweeps sources in order."""
    n_edges = int(n_nodes * avg_degree)

    def window(length: int, wseed: int) -> np.ndarray:
        rng = np.random.default_rng((seed, wseed))
        start = int(rng.integers(0, n_nodes))
        deg = max(1, int(np.ceil(avg_degree)))
        srcs = (start + np.arange(length // deg + 1)) % n_nodes
        src = np.repeat(srcs, deg)[:length]
        offs = rng.integers(-64, 65, size=length)
        dst = (src + offs) % n_nodes
        far = rng.random(length) < far_frac
        dst[far] = rng.integers(0, n_nodes, size=int(far.sum()))
        return dst

    return Graph(name=name, n_nodes=n_nodes, n_edges=n_edges,
                 measured_l2_hit=measured_l2_hit, _window_fn=window)


def paper_inputs(seed: int = 0) -> list[Graph]:
    """The three paper inputs at full scale (traces are lazy windows)."""
    return [
        roadnet(24_000_000, seed=seed),
        powerlaw(1_000_000, 10_000_000, alpha=0.6,
                 name="powerlaw-1M-10M", measured_l2_hit=0.20, seed=seed),
        powerlaw(10_000_000, 100_000_000, alpha=1.02,
                 name="powerlaw-10M-100M", measured_l2_hit=0.57,
                 seed=seed + 1),
    ]
