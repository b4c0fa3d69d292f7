"""Walks over the port's parameter and state trees: nested dicts, lists
and tuples of tensors, with ``None`` an empty subtree, as JAX's pytrees
treat it.  Dict keys are visited in sorted order, as ``jax.tree_util``
visits them, and a leaf's path joins its dict keys and list indices with
``/`` (``params/segments/0/attn/q/w``), as the JAX checkpointer names
it."""
from __future__ import annotations

from typing import Any, Callable, Iterator


def paths(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) of every leaf of ``tree``, in JAX's order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from paths(v, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], tree


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest`` (same structure), into ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def unflatten(tree: Any, flat: list) -> Any:
    """``tree``'s structure with its leaves, in :func:`paths` order,
    replaced by ``flat``."""
    it = iter(flat)

    def walk(node):
        if isinstance(node, dict):
            out = {k: walk(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return None if node is None else next(it)
    return walk(tree)
