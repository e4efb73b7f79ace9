"""Nested containers of tensors ("trees"), flattened in the reference's
order.

The reference's parameter, optimizer and checkpoint trees are JAX
pytrees; ``jax.tree_util`` flattens a dict by its sorted keys, a list or
tuple by index, skips ``None`` and treats anything else as a leaf. These
helpers do the same over the port's dicts and lists of tensors, so leaf
order and path strings (``keystr``: ``['params']['blocks']['slots'][0]``)
equal the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def _children(node) -> Iterator[tuple[str, Any]]:
    if isinstance(node, dict):
        for key in sorted(node):
            yield f"[{key!r}]", node[key]
    else:
        for i, child in enumerate(node):
            yield f"[{i}]", child


def _is_node(node) -> bool:
    return isinstance(node, (dict, list, tuple))


def leaves_with_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(keystr path, leaf)`` of every leaf, in the reference's order."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for key, child in _children(tree):
        out += leaves_with_paths(child, prefix + key)
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like, new_leaves) -> Any:
    """``like``'s structure with its leaves replaced, in order, by
    ``new_leaves`` (dicts keep ``like``'s key order)."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            done = {key: build(node[key]) for key in sorted(node)}
            return {key: done[key] for key in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(child) for child in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest`` (same structure, as ``jax.tree.map``)."""
    flat = leaves(tree)
    others = [leaves(t) for t in rest]
    if any(len(o) != len(flat) for o in others):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(flat, *others)])
