"""Parameter leaves with logical sharding axes, from
:mod:`repro.models.param`.

``P(value, axes)`` pairs a tensor with a tuple of logical axis names (one
per dim, ``None`` = replicated).  :func:`repro_torch.models.init.
abstract_ptree` builds a tree of ``P`` on the ``meta`` device;
:func:`unwrap` / :func:`axes_of` split it into a value tree and an axes
tree of the same structure (what
:func:`repro_torch.distributed.sharding.param_shardings` reads).  A
layer-stacked segment's leaf has one dim more than its axes: the layer
dim, which carries no axis, as in JAX.  Trees are walked with
:mod:`repro_torch.tree`, which treats a ``P`` as a leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from .. import tree


@dataclasses.dataclass
class P:
    value: Any
    axes: tuple[str | None, ...]


def is_param(x: Any) -> bool:
    return isinstance(x, P)


def unwrap(ptree: Any) -> Any:
    """Tree of P -> tree of tensors."""
    return tree.tree_map(lambda p: p.value, ptree)


def axes_of(ptree: Any) -> Any:
    """Tree of P -> tree of logical-axes tuples."""
    return tree.tree_map(lambda p: tuple(p.axes), ptree)


def shapes_of(ptree: Any) -> Any:
    """Tree of P -> tree of (shape, dtype)."""
    return tree.tree_map(lambda p: (tuple(p.value.shape), p.value.dtype),
                         ptree)


def n_params(ptree: Any) -> int:
    return int(sum(math.prod(p.value.shape) for p in tree.leaves(ptree)))


# ------------------------- initializers -----------------------------------

def normal(gen: torch.Generator, shape: tuple[int, ...],
           axes: tuple[str | None, ...], stddev: float = 0.02,
           dtype=torch.float32) -> P:
    """N(0, stddev) drawn from the explicit generator ``gen`` on its
    device."""
    return P(stddev * torch.randn(shape, generator=gen, dtype=dtype,
                                  device=gen.device), axes)


def zeros(shape: tuple[int, ...], axes: tuple[str | None, ...],
          dtype=torch.float32, device="cpu") -> P:
    return P(torch.zeros(shape, dtype=dtype, device=device), axes)


def ones(shape: tuple[int, ...], axes: tuple[str | None, ...],
         dtype=torch.float32, device="cpu") -> P:
    return P(torch.ones(shape, dtype=dtype, device=device), axes)


def abstract(shape: tuple[int, ...], axes: tuple[str | None, ...],
             dtype=torch.float32) -> P:
    """A ``meta``-tensor P: shape and dtype, no storage (the dry-run's
    init)."""
    return P(torch.empty(shape, dtype=dtype, device="meta"), axes)


def fanin_scale(shape: tuple[int, ...]) -> float:
    return float(1.0 / math.sqrt(max(1, shape[0])))
