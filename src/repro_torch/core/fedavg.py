"""FedAvg aggregation (McMahan et al. 2017), as used by the paper for the
discriminator parameters.  Port of ``repro/core/fedavg.py``.

Two forms:
  * fedavg(trees, weights)             host-side, cross-silo: an explicit
                                       list of client parameter trees (the
                                       paper's setting: the clients
                                       simulated one after another on one
                                       device).
  * fedavg_collective(tree, group)     in a process group: each rank holds
                                       one client's tree, and the average
                                       is one ``all_reduce`` a leaf over
                                       the group (the reference's
                                       ``lax.pmean`` over a mesh axis).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.tree import leaves, tree_map


def _check_same_structure(trees: Sequence) -> None:
    def structure(t):
        return tree_map(lambda _: None, t)
    s0 = structure(trees[0])
    for i, t in enumerate(trees[1:], 1):
        if structure(t) != s0:
            raise ValueError(f"client tree {i} structure differs from "
                             f"client 0")


def fedavg(trees: Sequence, weights: Optional[Sequence[float]] = None):
    """Weighted average of parameter trees (fp32 accumulate)."""
    if not trees:
        raise ValueError("fedavg of zero clients")
    _check_same_structure(trees)
    if weights is None:
        weights = [1.0] * len(trees)
    w = torch.tensor(weights, dtype=torch.float32,
                     device=leaves(trees[0])[0].device)
    w = w / torch.sum(w)

    def avg(*ls):
        acc = sum(l.to(torch.float32) * w[i] for i, l in enumerate(ls))
        return acc.to(ls[0].dtype)

    return tree_map(avg, *trees)


def _all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    """A float32 copy of ``x`` summed over ``group`` in place."""
    y = x.to(torch.float32, copy=True)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


def fedavg_collective(tree, group=None):
    """Average ``tree`` over the ranks of ``group`` (the default group when
    None), equal weights: each leaf's float32 sum over the ranks divided by
    the world size, cast back to the leaf's dtype.  Every rank returns the
    same tree; ``tree`` is not written."""
    n = torch.tensor(float(dist.get_world_size(group)))

    def avg(x):
        y = _all_reduce_f32(x, group)
        return y.div_(n.to(y.device)).to(x.dtype)

    return tree_map(avg, tree)


def fedavg_weighted_collective(tree, weight: float, group=None):
    """Weighted FedAvg over the ranks of ``group``: ``weight`` is this
    rank's client weight; each leaf's float32 sum of weight x leaf over the
    ranks divided by the summed weight, cast back."""
    dev = leaves(tree)[0].device
    wsum = _all_reduce_f32(torch.tensor(float(weight), device=dev), group)

    def avg(x):
        contrib = x.to(torch.float32) * weight
        dist.all_reduce(contrib, op=dist.ReduceOp.SUM, group=group)
        return (contrib / wsum).to(x.dtype)

    return tree_map(avg, tree)
