"""push-primitive (paper §2.3.3, §4.2.5, §5.1.3/§5.2.3), functional part.

From :mod:`repro.core.primitives.push`: push-based graph processing reads
each source vertex's value and updates every neighbour, an atomic
read-modify-write per edge.  The op that runs one push iteration on the
card is :func:`repro_torch.kernels.push_scatter.push_scatter` (hot/cold
split); this module holds the oracle and the model's constants.

The model half of the JAX module (``profile``, ``gpu_time_ns``,
``pim_stream``, ``pim_time``, ``gpu_feed_time_ns``, ``evaluate`` and
``PushResult``) needs the timing simulator and the cache model of
``repro.core`` and is not ported yet.
"""
from __future__ import annotations

import torch

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
