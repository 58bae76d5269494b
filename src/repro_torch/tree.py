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


def tree_unstack(tree: Any) -> List[Any]:
    """The inverse of `tree_stack`: one tree per index of the leading axis.
    Each leaf is split once (`unbind`), so under autograd its gradient is
    stacked once, not summed from one full-size zero-padded tensor per index."""
    parts = [t.unbind(0) for t in tree_leaves(tree)]
    out = []
    for i in range(len(parts[0])):
        it = iter([p[i] for p in parts])
        out.append(tree_map(lambda _: next(it), tree))
    return out


def leaf_grads(loss: torch.Tensor, params: Any) -> Any:
    """d loss / d each leaf of `params` (leaves that require grad), as a tree
    of the same structure; a leaf the loss does not reach gets zeros, as
    `jax.grad` gives it (the non-gated configs' allocated `w_gate`)."""
    grads = iter(torch.autograd.grad(loss, tree_leaves(params), allow_unused=True))
    return tree_map(lambda p: _or_zeros(next(grads), p), params)


def _or_zeros(g, p):
    return torch.zeros_like(p) if g is None else g


def requiring_grad(params: Any) -> Any:
    """The same storage, detached from any graph, each leaf requiring grad."""
    return tree_map(lambda t: t.detach().requires_grad_(True), params)


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
