"""Gradient compression: int8 quantization with error feedback, from
:mod:`repro.distributed.compression`.

Before the optimizer takes the gradients, each leaf plus its error
feedback is quantized to int8 with one per-tensor scale, ``max|x| / 127 +
1e-12``, rounded half to even (``torch.round``, as ``jnp.round``) and
clipped to +-127; the dequantized value goes on, and the residual stays
in the error-feedback buffer for the next step.  As in JAX, this runs on
the gradients a step already holds, so on one card it bounds optimizer
noise and moves no fewer bytes.
"""
from __future__ import annotations

import torch

from .. import tree

INT8_MAX = 127.0


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / INT8_MAX + 1e-12
    q = torch.clamp(torch.round(x / scale), -INT8_MAX, INT8_MAX).to(
        torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_leaf(g: torch.Tensor,
                  ef: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (decompressed gradient, new error-feedback buffer)."""
    g32 = g.float() + ef.float()
    q, scale = quantize(g32)
    deq = dequantize(q, scale)
    return deq, (g32 - deq).to(ef.dtype)


def compress_tree(grads, ef):
    """(decompressed gradients, new error feedback), leaf by leaf."""
    pairs = [compress_leaf(g, e)
             for g, e in zip(tree.leaves(grads), tree.leaves(ef))]
    return (tree.unflatten(grads, [g for g, _ in pairs]),
            tree.unflatten(ef, [e for _, e in pairs]))
