"""Public push op, from :mod:`repro.kernels.push_scatter.ops`: the
locality predictor (degree ranking) and the hot/cold execution.

Routing is by the tensors' device and nothing else: CUDA tensors go to the
hand-written kernel (:mod:`.kernel`), CPU tensors to its plain version
(:mod:`.ref`).  There is no fallback: a CUDA call the kernel cannot take
raises.  As in the JAX op, the flush of the hot accumulator to its rows
and the cold updates' scatter are plain ops (``index_add_``) outside the
kernel.  The kernel takes any number of updates, so they are not padded to
a tile.  There is no ``interpret`` flag.
"""
from __future__ import annotations

import torch

from . import kernel, ref

HOT = 1024   # hot-set rows of the accumulator


def _hot_slots(dst: torch.Tensor, n_nodes: int, hot: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(top, slot_of): the ``hot`` most-updated destinations, most updates
    first and the lower node first on a tie, as ``jax.lax.top_k`` orders
    them (a stable descending sort; ``torch.topk`` does not promise that
    order), and [n_nodes] int32 with each one's slot, -1 elsewhere.  Counts
    follow ``jnp.bincount(length=n_nodes)``: a negative destination counts
    as node 0, one at or past ``n_nodes`` is not counted."""
    counts = torch.bincount(dst.clamp_min(0), minlength=n_nodes)[:n_nodes]
    top = torch.sort(counts, descending=True,
                     stable=True).indices[:min(hot, n_nodes)]
    slot_of = torch.full((n_nodes,), -1, dtype=torch.int32,
                         device=dst.device)
    slot_of[top] = torch.arange(top.shape[0], dtype=torch.int32,
                                device=dst.device)
    return top, slot_of


def hot_set(dst: torch.Tensor, n_nodes: int, hot: int = HOT) -> torch.Tensor:
    """Locality predictor: the ``hot`` most-updated destinations.

    Returns [n_nodes] int32: slot id in the hot accumulator, or -1.
    (Degree ranking is the static locality predictor of §5.1.3: reuse is
    literally update frequency for scatter-adds.)
    """
    return _hot_slots(dst, n_nodes, hot)[1]


def push_scatter(values: torch.Tensor, contrib: torch.Tensor,
                 dst: torch.Tensor, *, hot: int = HOT) -> torch.Tensor:
    """values [N] += scatter(contrib [U] at dst [U]), hot/cold partitioned.
    The sum is taken in float32 and returned in values' dtype."""
    n = values.shape[0]
    hot = min(hot, n)
    top, slot_of = _hot_slots(dst, n, hot)
    slots = slot_of[dst]                             # [U]: hot slot or -1
    val = contrib.to(torch.float32).contiguous()
    if values.device.type == "cuda":
        hot_acc, cold_vals = kernel.push_scatter_cuda(slots, val, hot)
    else:
        hot_acc, cold_vals = ref.push_scatter_kernel_ref(slots, val, hot)
    out = values.to(torch.float32, copy=True)
    out.index_add_(0, top, hot_acc)      # cache side: flush the hot rows
    out.index_add_(0, dst, cold_vals)    # PIM side: the cold scatter
    return out.to(values.dtype)
