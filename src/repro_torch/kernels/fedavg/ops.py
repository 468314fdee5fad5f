"""Public fedavg op: tree <-> flat glue around the fedavg kernel (port of
``repro/kernels/fedavg/ops.py``).

A CUDA tensor goes through the hand-written kernel, which launches or
raises; a CPU tensor takes the plain version (``ref.py``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels.fedavg.kernel import fedavg_kernel
from repro_torch.kernels.fedavg.ref import fedavg_ref
from repro_torch.tree import leaves, unflatten_like


def fedavg_flat(stacked: torch.Tensor, weights: torch.Tensor
                ) -> torch.Tensor:
    """stacked: (C, N) fp32 -> (N,): the average weighted by ``weights``
    (normalised here)."""
    w = weights / torch.sum(weights)
    if stacked.device.type == "cuda":
        return fedavg_kernel(stacked, w)
    if stacked.device.type == "cpu":
        return fedavg_ref(stacked, w)
    raise ValueError(f"fedavg_flat: no path for device {stacked.device}")


def fedavg_trees(trees: Sequence, weights: Optional[Sequence[float]] = None):
    """FedAvg over a list of same-structure parameter trees, one
    :func:`fedavg_flat` per leaf (sorted-key leaf order)."""
    if not trees:
        raise ValueError("fedavg of zero clients")
    if weights is None:
        weights = [1.0] * len(trees)
    flats = [leaves(t) for t in trees]
    if any(len(f) != len(flats[0]) for f in flats):
        raise ValueError("client trees differ in structure")
    w = torch.tensor(weights, dtype=torch.float32,
                     device=flats[0][0].device)
    out_leaves = []
    for ls in zip(*flats):
        shape, dtype = ls[0].shape, ls[0].dtype
        stacked = torch.stack([l.reshape(-1).to(torch.float32) for l in ls])
        avg = fedavg_flat(stacked, w)
        out_leaves.append(avg.reshape(shape).to(dtype))
    return unflatten_like(trees[0], out_leaves)
