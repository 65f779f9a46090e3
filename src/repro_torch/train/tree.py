"""Nested dicts of tensors as the port's pytrees: leaves in the order
``jax.tree`` flattens a dict (sorted keys, depth first), and paths joined
with ``/`` as the reference's checkpoints name them."""
from __future__ import annotations

from typing import Callable, Iterator


def items(tree, prefix: str = "") -> Iterator[tuple]:
    """(path, leaf) for every leaf, in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from items(tree[k], f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def leaves(tree) -> list:
    return [v for _, v in items(tree)]


def map(fn: Callable, tree, *rest):
    """fn over the leaves of ``tree`` and the matching leaves of ``rest``
    (same structure), as a new tree."""
    if isinstance(tree, dict):
        return {k: map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def unflatten(paths: list, values: list) -> dict:
    """The nested dict with ``values`` at ``paths``."""
    out: dict = {}
    for path, v in zip(paths, values):
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out
