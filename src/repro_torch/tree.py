"""Nested-dict helpers: the port's stand-in for ``jax.tree_util``.

Parameters, gradients and optimizer moments are nested dicts whose leaves
are tensors (or numpy arrays in ``convert``). Leaves are visited in the
dicts' insertion order.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator


def leaves(tree) -> Iterator[Any]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of trees with one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def unflatten(tree, values: Iterable):
    """A tree shaped like ``tree`` whose leaves are ``values`` in order."""
    it = iter(values)
    return tree_map(lambda _: next(it), tree)
