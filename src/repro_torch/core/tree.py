"""Nested containers of tensors (the JAX package's pytrees), flattened in
JAX's order.

A tree is a dict (flattened in sorted key order, as ``jax.tree`` does), a
list or a tuple of trees, ``None`` (no leaves) or a leaf.  The leaf order
fixes the byte layout of a coalesced staging buffer and of a spill chunk,
so it must be the JAX package's for the two to agree byte for byte.
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["flatten", "unflatten", "leaves", "tree_map", "structure"]


def _children(node: Any):
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", tuple(keys)), [node[k] for k in keys]
    if isinstance(node, tuple) and not hasattr(node, "_fields"):
        return ("tuple", len(node)), list(node)
    if isinstance(node, list):
        return ("list", len(node)), list(node)
    if node is None:
        return ("none", 0), []
    return None, None


def flatten(tree: Any) -> tuple[list, Any]:
    """``(leaves, treedef)``; ``unflatten(treedef, leaves)`` rebuilds it."""
    out: list = []

    def walk(node):
        kind, kids = _children(node)
        if kind is None:
            out.append(node)
            return "*"
        return (kind, tuple(walk(k) for k in kids))

    return out, walk(tree)


def unflatten(treedef: Any, leaves: list) -> Any:
    it = iter(leaves)

    def build(d):
        if d == "*":
            return next(it)
        (kind, meta), kids = d
        vals = [build(k) for k in kids]
        if kind == "dict":
            return dict(zip(meta, vals))
        if kind == "tuple":
            return tuple(vals)
        if kind == "list":
            return vals
        return None

    return build(treedef)


def leaves(tree: Any) -> list:
    return flatten(tree)[0]


def structure(tree: Any) -> Any:
    return flatten(tree)[1]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over corresponding leaves of trees of one structure."""
    flat, treedef = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])
