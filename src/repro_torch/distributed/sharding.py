"""Logical-axis sharding rules (MaxText-style) on a torch ``DeviceMesh``,
from :mod:`repro.distributed.sharding`.

Parameters carry logical axis names (:mod:`repro_torch.models.param`);
the rules map them onto the mesh's named dims, which keep JAX's names:

  * ``model`` carries tensor/expert parallelism: heads, mlp hidden, vocab,
    experts;
  * ``data`` doubles as the FSDP axis: the *embed* dim of every weight is
    sharded over it (params and optimizer state fully sharded; the
    port's sharded ops gather a weight's ``data`` shards where they use
    it, as XLA inserts the per-layer all-gathers);
  * ``batch`` shards over ``(pod, data)``, pod-major.

Conflict and divisibility handling is JAX's: a mesh axis is used at most
once per tensor (first dim wins), and a mapping whose axis-size product
does not divide the dim falls back to fewer axes (then replication).

:func:`spec_for` returns a :class:`PartitionSpec`, a tuple of one entry a
tensor dim (``None``, an axis name, or a tuple of names), equal as a
tuple to JAX's.  :func:`placements` turns it into DTensor placements (one
``Shard(dim)`` / ``Replicate()`` a mesh dim), the one function JAX does
not need; two mesh dims on one tensor dim split it in mesh order, so
``("pod", "data")`` is pod-major, as JAX's, while ``vocab``'s
``("model", "data")`` is split data-major (a permutation of JAX's row
blocks: the local shapes are the same).  A :class:`NamedSharding` pairs a
mesh and a spec, as JAX's does.  The rules read only a mesh's dim names
and sizes (:func:`axis_sizes`), so a stand-in mesh with JAX's
``axis_names`` and ``devices.shape`` works too.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from .. import tree
from ..models import param as pm

LOGICAL_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    # vocab-dim sharding over both axes for the embedding and LM-head
    # tables; their embed dim stays replicated ("embed_r") so the logits
    # contraction never partial-sums over a sharded d.  Other weights keep
    # embed -> data (FSDP).
    "vocab": ("model", "data"),
    "embed_r": (),
    "embed": ("data",),          # FSDP
    # context parallelism: when an arch's head count does not divide the
    # model axis (qwen2 14H, starcoder2 24H, whisper 6H) the attention
    # layer shards its sequence dim instead
    "ctx": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "q_lora": ("model",),
    "kv_lora": (),
    "mlp": ("model",),
    "experts": ("model",),
    "conv": (),
    "state": (),
    "seq": (),
    "layers": (),
}


class PartitionSpec(tuple):
    """One entry a tensor dim: None, a mesh axis name, or a tuple of
    names (JAX's ``PartitionSpec`` as a tuple)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a torch ``DeviceMesh`` or of a stand-in with
    JAX's ``axis_names`` and ``devices.shape``."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def spec_for(axes: tuple[str | None, ...], shape: tuple[int, ...], mesh,
             rules: dict | None = None) -> PartitionSpec:
    rules = rules or LOGICAL_RULES
    sizes = axis_sizes(mesh)
    used: set[str] = set()
    entries: list[Any] = []
    for dim, name in zip(shape, axes):
        targets = rules.get(name, ()) if name else ()
        targets = tuple(t for t in targets if t in sizes and t not in used)
        # progressively drop axes until the product divides the dim
        while targets:
            prod = math.prod(sizes[t] for t in targets)
            if prod > 1 and dim % prod == 0:
                break
            targets = targets[:-1]
        if targets and math.prod(sizes[t] for t in targets) > 1:
            used.update(targets)
            entries.append(targets if len(targets) > 1 else targets[0])
        else:
            entries.append(None)
    return PartitionSpec(*entries)


def placements(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim named in entry d, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec, JAX's ``NamedSharding``."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def place(self, x: torch.Tensor):
        """``x`` (a whole tensor, the same on every rank) as a DTensor
        with this sharding: each rank keeps its own shard, nothing is
        sent."""
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(x, self.mesh, self.placements,
                                 src_data_rank=None)


def place_tree(values: Any, shardings: Any) -> Any:
    """Every tensor of ``values`` placed by the matching sharding (a leaf
    that is already a DTensor is kept)."""
    from torch.distributed.tensor import DTensor
    return tree.tree_map(
        lambda x, s: x if isinstance(x, DTensor) else s.place(x),
        values, shardings)


def param_shardings(param_tree: Any, mesh, rules: dict | None = None) -> Any:
    """Tree of P -> tree of NamedSharding (stacked segment params get a
    leading replicated layer dim, detected by rank mismatch)."""
    def leaf(p: pm.P):
        axes = tuple(p.axes)
        shape = tuple(p.value.shape)
        if len(axes) == len(shape) - 1:      # layer-stacked segment
            axes = (None,) + axes
        elif len(axes) != len(shape):
            raise ValueError(f"axes {axes} vs shape {shape}")
        return NamedSharding(mesh, spec_for(axes, shape, mesh, rules))
    return tree.tree_map(leaf, param_tree)


def batch_spec(shape: tuple[int, ...], mesh,
               extra: tuple[str | None, ...] | None = None) -> PartitionSpec:
    """Sharding for an activation whose dim0 is batch."""
    axes = ("batch",) + (extra or (None,) * (len(shape) - 1))
    return spec_for(axes, shape, mesh)


def data_shardings(values: Any, mesh, *, batch_dim: int = 0) -> Any:
    """Shard every tensor in a tree along its batch dim (replicate the
    rest)."""
    def leaf(x):
        shape = tuple(x.shape)
        axes: list[str | None] = [None] * len(shape)
        if len(shape) > batch_dim:
            axes[batch_dim] = "batch"
        return NamedSharding(mesh, spec_for(tuple(axes), shape, mesh))
    return tree.tree_map(leaf, values)


def cache_shardings(caches: Any, mesh) -> Any:
    """Dense-stripe KV and SSM cache shardings: [layers, batch, seq|*,
    heads-ish, ...], keyed on each leaf's path as JAX's (the port's cache
    trees keep its ``k``/``v``/``conv``/``state`` names).

    dim0 = stacked layers (replicated), dim1 = batch.  Attention stripes
    shard their *sequence* dim over the model axis ("ctx"); kv_heads take
    the model axis only when the sequence dim cannot.  The port's stripe
    ends in a sink row that takes dropped writes (:mod:`repro_torch.
    models.attention`); it is not a position, so the sequence dim counts
    ``rows - 1`` positions for the rule, and its shards are uneven by that
    row."""
    def leaf(key, x):
        shape = tuple(x.shape)
        axes: list[str | None] = [None] * len(shape)
        if len(shape) >= 2:
            axes[1] = "batch"
        rule_shape = list(shape)
        if "state" in key and len(shape) >= 4:     # [L, B, H, P, N]
            axes[2] = "heads"
        elif "conv" in key and len(shape) >= 4:    # [L, B, k, C]
            axes[3] = "mlp"
        elif len(shape) == 4:                      # MLA latent [L, B, S, r]
            axes[2] = "ctx"
            rule_shape[2] -= 1
        elif len(shape) >= 5:                      # attn [L, B, S, H, D]
            axes[2] = "ctx"
            axes[3] = "kv_heads"
            rule_shape[2] -= 1
        return NamedSharding(mesh, spec_for(tuple(axes), tuple(rule_shape),
                                            mesh))
    flat = [leaf(key, x) for key, x in tree.paths(caches)]
    return tree.unflatten(caches, flat)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
