"""Nested containers of tensors (the port's stand-in for ``jax.tree``).

A tree is a nesting of dicts, lists, tuples and named tuples; ``None`` is
an empty node, as in JAX, so the UNet's absent blocks carry through
untouched; anything else is a leaf. Dicts keep their insertion order.
"""
from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *leaves at the same place in rest)`` over ``tree``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(template: Any, leaves: List[Any]) -> Any:
    """``template``'s structure with ``leaves`` in ``tree_leaves`` order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, it) is not it:
        raise ValueError("more leaves than the template holds")
    return out


def tree_structure(tree: Any) -> str:
    """The structure with every leaf shown as ``*`` (for a manifest)."""
    return repr(tree_map(lambda _: "*", tree))
