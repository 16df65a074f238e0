"""Pytrees of tensors, the port's counterpart of ``jax.tree``.

A pytree is a nested dict, list, tuple or named tuple of leaves; ``None``
is an empty subtree.  Leaves are taken in JAX's order (dicts by sorted key,
sequences and named-tuple fields in order), and ``paths`` names them as
``jax.tree_util.keystr`` does (``[0]['blocks']['wq']``, ``[1].step``), so
that a tree flattened here lines up leaf for leaf with the same tree
flattened by JAX.
"""
from __future__ import annotations

from typing import Any, Callable, List

__all__ = ["leaves", "tree_map", "paths", "unflatten"]


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _children(tree):
    """(key string, child) pairs of an inner node, in JAX's order; None for
    a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", t) for i, t in enumerate(tree)]
    return None


def _rebuild(tree, children: List[Any]):
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), children))
    if _is_namedtuple(tree):
        return type(tree)(*children)
    return type(tree)(children)


def leaves(tree) -> List[Any]:
    """The leaves, in ``jax.tree.leaves`` order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for _, child in kids for leaf in leaves(child)]


def paths(tree, prefix: str = "") -> List[str]:
    """Each leaf's path, as ``jax.tree_util.keystr`` writes it."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [prefix]
    return [p for key, child in kids for p in paths(child, prefix + key)]


def tree_map(fn: Callable, tree):
    """``fn`` over every leaf, keeping the structure."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(tree)
    return _rebuild(tree, [tree_map(fn, child) for _, child in kids])


def unflatten(template, values: List[Any]):
    """``template``'s structure with its leaves replaced, in order, by
    ``values`` (as many as ``template`` has leaves)."""
    n = len(leaves(template))
    if len(values) != n:
        raise ValueError(f"{len(values)} values for a template of {n} "
                         f"leaves")
    it = iter(values)
    return tree_map(lambda _: next(it), template)
