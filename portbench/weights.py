"""Seeded weights for a configuration, made on the device in the port's
parameter layout.

The benchmark makes the weights itself and hands the same tensors to the
program and to the reference.  The layout (tree, shapes, logical axes)
is the port's own, read from ``Model.abstract_ptree()``, which allocates
nothing; the values are drawn here.  Every drawn leaf of one storage
dtype is a view into one flat buffer, filled by a few large ``normal_``
calls from a ``torch.Generator`` on the device, then scaled leaf by leaf
in place:

- the embedding table and a router: N(0, 0.02);
- every other projection: N(0, 1 / fan_in), with fan_in the leaf's input
  dims (the axes before the output ones: all but the last when the last
  is the model width, else the first; a layer dim and an ``experts`` axis
  are batch dims);
- norm scales one, biases zero.

The storage dtype is the one the port serves a leaf in: the norm scales,
the embedding, the read-out and a router stay float32, everything else
is ``dtype`` (bfloat16).
"""
from __future__ import annotations

import math

import torch

CHUNK = 1 << 30          # values a normal_ call draws at most


def serves_in_float32(path: tuple[str, ...]) -> bool:
    """The leaves the port keeps in float32 when it serves in a lower
    dtype: norm scales, the embedding, the read-out and a router."""
    return (path[-1] == "scale" or path[:1] in (("embed",), ("lm_head",))
            or path[-2:] == ("router", "w"))


def _std(path: tuple[str, ...], shape: tuple[int, ...],
         axes: tuple) -> float:
    if path[-1] == "table" or path[-2:] == ("router", "w"):
        return 0.02
    dims = list(zip(shape[len(shape) - len(axes):], axes))
    dims = [(n, a) for n, a in dims if a != "experts"]
    if dims[-1][1] in ("embed", "embed_r"):
        fan_in = math.prod(n for n, _ in dims[:-1])
    else:
        fan_in = dims[0][0]
    return 1.0 / math.sqrt(max(1, fan_in))


def _leaves(node, path=()):
    """(path, P leaf) pairs of a tree of dicts and lists, in order."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _leaves(v, path + (i,))
    else:
        yield path, node


def _set(tree, path, value) -> None:
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _skeleton(node):
    if isinstance(node, dict):
        return {k: _skeleton(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_skeleton(v) for v in node]
    return None


def make_weights(abstract_ptree, seed: int, device: torch.device,
                 dtype: torch.dtype = torch.bfloat16) -> dict:
    """The weight tree for ``abstract_ptree`` (the port's tree of
    ``P(meta tensor, axes)`` leaves) drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    out = _skeleton(abstract_ptree)
    drawn: dict[torch.dtype, list] = {}
    for path, leaf in _leaves(abstract_ptree):
        names = tuple(p for p in path if isinstance(p, str))
        shape = tuple(leaf.value.shape)
        leaf_dtype = torch.float32 if serves_in_float32(names) else dtype
        if names[-1] == "scale":
            _set(out, path, torch.ones(shape, dtype=leaf_dtype,
                                       device=device))
        elif names[-1] == "b":
            _set(out, path, torch.zeros(shape, dtype=leaf_dtype,
                                        device=device))
        else:
            drawn.setdefault(leaf_dtype, []).append(
                (path, shape, _std(names, shape, tuple(leaf.axes))))
    for leaf_dtype, items in drawn.items():
        total = sum(math.prod(s) for _, s, _ in items)
        flat = torch.empty(total, dtype=leaf_dtype, device=device)
        for start in range(0, total, CHUNK):
            flat[start:start + CHUNK].normal_(0.0, 1.0, generator=gen)
        at = 0
        for path, shape, std in items:
            n = math.prod(shape)
            view = flat[at:at + n].view(shape)
            view.mul_(std)
            _set(out, path, view)
            at += n
    return out
