"""push-primitive (paper §2.3.3, §4.2.5, §5.1.3/§5.2.3), functional part.

From :mod:`repro.core.primitives.push`: push-based graph processing reads
each source vertex's value and updates every neighbour, an atomic
read-modify-write per edge.  The op that runs one push iteration on the
card is :func:`repro_torch.kernels.push_scatter.push_scatter` (hot/cold
split); this module holds the oracle and the paper's model of it.

Irregular destinations preclude broadcast commands and co-location, so the
offload uses **single-bank** pim-commands: per edge a *pim-ADD* (loads the
current destination value, adds the operand supplied on the data bus,
result to a pim-register) plus a *pim-store* (writes the register back;
carries no data — the §5.1.4 command-bandwidth-limit protagonist).

GPU baseline: destination updates are line-granular with the measured L2
hit rates; source values and edge indices stream.

Cache-aware PIM (§5.1.3): a locality predictor (the LRU cache model)
classifies each update; predicted-hot updates are performed in cache by the
GPU, the cold remainder via PIM — both proceed concurrently.  Cache-aware
GPU: the same predictor lets the GPU drop to 32 B accesses for cold updates.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import gpu_model
from ..amenability import Interaction, PrimitiveProfile
from ..cache_model import sampled_hit_rate
from ..commands import Kind, Node, Seg, Subset
from ..hwspec import GpuSpec, PimSpec
from ..timing import TimingStats, simulate
from .graphs import Graph

VALUE_BYTES = 2      # fp16 computational value (PIM operand width is 32 B)
PROP_BYTES = 32      # full vertex-property struct (graphBIG-style: value +
                     # degree + flags + padding) = one DRAM word, the
                     # granularity both the cache and pim-commands touch
INDEX_BYTES = 8      # (src, dst) 32-bit pair per edge in traversal order
COLD_ROW_HIT = 0.3   # row locality of cache-*missing* updates (scattered)
HOT_ROW_HIT = 0.85   # destination-bucketed full streams


def reference(values: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              n_nodes: int) -> torch.Tensor:
    """One push iteration: out[d] += f(values[s]) for every edge (s, d),
    with f(x) = 0.85 * x, in ``values``' dtype (float64 values give a
    float64 oracle).  Atomicity is by construction (a segment sum)."""
    contrib = 0.85 * values[src]
    acc = torch.zeros(n_nodes, dtype=values.dtype, device=values.device)
    return values + acc.index_add_(0, dst, contrib)


# ------------------------- amenability ------------------------------------

def profile(graph: Graph) -> PrimitiveProfile:
    e = graph.n_edges
    nbytes = e * (INDEX_BYTES + 2 * VALUE_BYTES)
    return PrimitiveProfile(
        name=f"push[{graph.name}]", ops=float(2 * e),
        mem_bytes=float(nbytes),
        onchip_bytes=float(e * VALUE_BYTES * graph.measured_l2_hit + 1),
        interaction=Interaction.IRREGULAR, alignable=False,
        input_dependent_locality=True,
        notes="single-bank commands only; command-bandwidth bound",
    )


# ------------------------- GPU baseline -----------------------------------

def gpu_time_ns(graph: Graph, gpu: GpuSpec, *, hit_rate: float | None = None,
                cache_aware: bool = False) -> float:
    """Edge stream + line-granular destination updates.

    Source properties are swept in order (cache-friendly, charged to
    neither side); the irregular destination updates dominate.  Baseline:
    each missing update fetches a 64 B line.  Cache-aware GPU (§5.2.3):
    the predictor lets cold updates use 32 B accesses instead.
    """
    h = graph.measured_l2_hit if hit_rate is None else hit_rate
    e = graph.n_edges
    stream = e * INDEX_BYTES
    gran = gpu.reduced_access_bytes if cache_aware else gpu.cache_line_bytes
    update = e * (1.0 - h) * gran
    return gpu_model.time_ns(stream + update, gpu)


# ------------------------- PIM -------------------------------------------

def pim_stream(graph: Graph, pim: PimSpec, *, n_updates: int | None = None,
               row_hit_frac: float = HOT_ROW_HIT) -> list[Node]:
    """Single-bank stream for ``n_updates`` edges (per stack; the engine
    models one pCH so counts are divided by pch_per_stack).

    ``row_hit_frac``: destination-bucketed processing (sorting updates by
    destination region, which the blocked layout encourages) gives most
    updates an already-open row; the remainder pay a bank activation.
    """
    e = (graph.n_edges if n_updates is None else n_updates)
    per_pch = max(1, e // pim.pch_per_stack)
    return [
        Seg(Kind.PIM_SB, Subset.ALL, per_pch, carries_data=True,
            row_hit_frac=row_hit_frac),                        # pim-ADD
        Seg(Kind.PIM_SB, Subset.ALL, per_pch, carries_data=False,
            row_hit_frac=1.0),                                 # pim-store
    ]


def pim_time(graph: Graph, pim: PimSpec, *, n_updates: int | None = None,
             row_hit_frac: float = HOT_ROW_HIT) -> TimingStats:
    return simulate(pim_stream(graph, pim, n_updates=n_updates,
                               row_hit_frac=row_hit_frac), pim)


def gpu_feed_time_ns(graph: Graph, gpu: GpuSpec,
                     n_updates: int | None = None) -> float:
    """GPU-side work to drive PIM: stream the edge list (source property
    reads sweep in order and stay cached, as in the baseline)."""
    e = graph.n_edges if n_updates is None else n_updates
    return gpu_model.time_ns(e * INDEX_BYTES, gpu)


@dataclasses.dataclass(frozen=True)
class PushResult:
    gpu_ns: float
    pim_baseline_ns: float
    pim_cache_aware_ns: float
    gpu_cache_aware_ns: float
    predictor_hit_rate: float

    @property
    def speedup_baseline(self) -> float:
        return self.gpu_ns / self.pim_baseline_ns

    @property
    def speedup_cache_aware(self) -> float:
        return self.gpu_ns / self.pim_cache_aware_ns

    @property
    def speedup_gpu_cache_aware(self) -> float:
        return self.gpu_ns / self.gpu_cache_aware_ns


def evaluate(graph: Graph, pim: PimSpec, gpu: GpuSpec, *,
             predictor_sample: int = 400_000, seed: int = 0) -> PushResult:
    """Full §5.2.3 comparison for one graph input."""
    # Locality predictor: classify updates with the LRU cache model on a
    # sampled window of the destination trace.
    window = graph.trace_window(predictor_sample, seed=seed)
    addrs = window.astype(np.int64) * PROP_BYTES
    cache = sampled_hit_rate(addrs, sample=predictor_sample, seed=seed,
                             spec=gpu)
    pred_hit = cache.hit_rate

    # The predictor's model hit rate is used consistently for the GPU
    # baseline too (the synthetic graphs are calibrated so it lands on the
    # paper's measured rocprof rates).
    gpu_ns = gpu_time_ns(graph, gpu, hit_rate=pred_hit)
    pim_base = pim_time(graph, pim).time_ns + gpu_feed_time_ns(graph, gpu)

    # Cache-aware PIM: hot updates in cache (on the GPU, ~free bandwidth),
    # cold via PIM; the GPU still streams the edge list.  GPU-side feed and
    # PIM-side execution overlap; the slower dominates (with a 15% residual
    # for the imperfect overlap).  Cold updates are the scattered ones, so
    # their row locality is poor (COLD_ROW_HIT).
    cold = int(graph.n_edges * (1.0 - pred_hit))
    pim_cold = pim_time(graph, pim, n_updates=max(1, cold),
                        row_hit_frac=COLD_ROW_HIT).time_ns
    feed = gpu_feed_time_ns(graph, gpu)
    pim_ca = max(pim_cold, feed) + 0.15 * min(pim_cold, feed)

    gpu_ca = gpu_time_ns(graph, gpu, hit_rate=pred_hit, cache_aware=True)
    return PushResult(gpu_ns=gpu_ns, pim_baseline_ns=pim_base,
                      pim_cache_aware_ns=pim_ca, gpu_cache_aware_ns=gpu_ca,
                      predictor_hit_rate=pred_hit)
