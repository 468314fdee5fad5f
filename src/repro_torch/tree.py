"""Parameter trees: nested dicts of tensors, walked in sorted-key order.

``jax.tree.leaves`` visits dict keys in sorted order, while
``torch.utils._pytree`` keeps insertion order.  Every flat view of a tree in
this package (leaf lists, the per-leaf FedAvg, byte counts) goes through
these helpers, so leaf ``i`` here is leaf ``i`` of the same tree in the JAX
package.  Any value that is not a dict is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch


def leaves(tree) -> List[Any]:
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if not isinstance(tree, dict):
        return [tree]
    out: List[Any] = []
    for k in sorted(tree):
        out.extend(leaves(tree[k]))
    return out


def _check_same_keys(tree, other) -> None:
    if isinstance(tree, dict) != isinstance(other, dict) or (
            isinstance(tree, dict) and set(tree) != set(other)):
        raise ValueError("trees differ in structure")


def tree_map(fn: Callable[..., Any], tree, *rest):
    """``fn`` applied leaf-wise over ``tree`` and trees of the same keys."""
    for r in rest:
        _check_same_keys(tree, r)
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
            for k in sorted(tree)}


def unflatten_like(tree, flat: Sequence[Any]):
    """Inverse of :func:`leaves`: ``flat`` laid into ``tree``'s keys."""
    it = iter(flat)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def value_and_grad(fn: Callable[..., torch.Tensor]
                   ) -> Callable[..., Tuple[torch.Tensor, Dict[str, Any]]]:
    """``jax.value_and_grad`` for a scalar ``fn(params, *args)``: returns
    the detached loss and the gradient tree of ``params``.  ``params`` are
    not modified."""
    def wrapped(params, *args):
        with torch.enable_grad():
            live = tree_map(lambda p: p.detach().requires_grad_(True),
                            params)
            loss = fn(live, *args)
            grads = torch.autograd.grad(loss, leaves(live))
        return loss.detach(), unflatten_like(params, grads)
    return wrapped
