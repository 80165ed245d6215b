"""Nested dicts and lists of tensors: the port's pytrees.

Leaves come in ``jax.tree.leaves``'s order — dict keys sorted, list
items by index — so a loop over the leaves of the port's parameters
visits them as the reference's ``jax.tree.map`` does (block by block
where the reference has one stacked leaf).
"""
from __future__ import annotations

from typing import Callable, Iterator, Optional


def leaves_with_paths(tree, prefix: tuple = ()) -> list[tuple[tuple, object]]:
    """[(path, leaf)]: a path holds the dict keys and list indices from
    the root."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in leaves_with_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in leaves_with_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def reference_path(path: tuple) -> tuple[tuple, Optional[int]]:
    """(the reference's path, the block index) of a path into the port's
    parameters: the reference stacks the blocks that the port keeps as
    the list ``params["layers"]``, so the index right after a ``layers``
    key is its leading axis, not a path part."""
    for i in range(1, len(path)):
        if path[i - 1] == "layers" and isinstance(path[i], int):
            return path[:i] + path[i + 1:], path[i]
    return path, None


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of ``tree``; lists stay lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def unflatten(template, new_leaves: list):
    """``template``'s structure with ``new_leaves`` (in ``leaves`` order)
    in place of its leaves."""
    it: Iterator = iter(new_leaves)

    def fill(t):
        if isinstance(t, dict):
            filled = {k: fill(t[k]) for k in sorted(t)}
            return {k: filled[k] for k in t}
        if isinstance(t, (list, tuple)):
            return [fill(v) for v in t]
        return next(it)

    out = fill(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out
