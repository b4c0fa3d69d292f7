"""Plain PyTorch versions of the push scatter, from
:mod:`repro.kernels.push_scatter.ref`: the op oracle, and the plain
version of the CUDA kernel on the kernel's own arguments.  They are the
CPU path of :mod:`.ops` and what the kernel is held against on the card.
Both compute in float32, or in float64 for float64 inputs."""
from __future__ import annotations

import torch


def push_scatter_ref(values: torch.Tensor, contrib: torch.Tensor,
                     dst: torch.Tensor) -> torch.Tensor:
    """values: [N], contrib: [U], dst: [U] -> values + segment_sum."""
    acc = torch.zeros_like(values).index_add_(0, dst, contrib.to(values.dtype))
    return values + acc


def push_scatter_kernel_ref(dst_hot: torch.Tensor, val: torch.Tensor,
                            hot: int) -> tuple[torch.Tensor, torch.Tensor]:
    """dst_hot [U] int32 (hot slot or -1), val [U] -> (hot_acc [hot],
    cold_vals [U]).  An update with a slot is hot: it adds to its slot (a
    slot at or past ``hot`` adds nothing, as in the TPU kernel's one-hot
    product) and its cold value is 0; any other keeps its value."""
    ct = torch.float64 if val.dtype == torch.float64 else torch.float32
    val = val.to(ct)
    is_hot = dst_hot >= 0
    inside = is_hot & (dst_hot < hot)
    hot_acc = torch.zeros(hot, dtype=ct, device=val.device).index_add_(
        0, dst_hot[inside], val[inside])
    return hot_acc, torch.where(is_hot, torch.zeros_like(val), val)
