"""Nested-dict parameter trees: the port keeps the JAX pytree's layout
(dicts of dicts of tensors, tuples for (k, v) pairs) and these helpers stand
in for `jax.tree.map` / `jax.tree.leaves` over it."""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch


def tree_map(fn: Callable, *trees: Any) -> Any:
    """Apply `fn` leaf-wise over trees of the same structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (tuple, list)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    if t0 is None:
        return None
    return fn(*trees)


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_stack(trees: List[Any]) -> Any:
    """Stack same-structured trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """{"a": {"b": x}} -> {"a/b": x} (the checkpoint manifest's keys)."""
    flat: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(flatten(v, key + "/"))
        else:
            flat[key] = v
    return flat


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree
