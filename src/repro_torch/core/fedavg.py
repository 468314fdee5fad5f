"""FedAvg aggregation (McMahan et al. 2017), as used by the paper for the
discriminator parameters.  Port of ``repro/core/fedavg.py`` (the host form;
the in-mesh collective forms wait for the LM's sharded runtime, ROADMAP
Queue A item 16).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.tree import leaves, tree_map


def fedavg(trees: Sequence, weights: Optional[Sequence[float]] = None):
    """Weighted average of parameter trees (fp32 accumulate)."""
    if not trees:
        raise ValueError("fedavg of zero clients")
    if weights is None:
        weights = [1.0] * len(trees)
    w = torch.tensor(weights, dtype=torch.float32,
                     device=leaves(trees[0])[0].device)
    w = w / torch.sum(w)

    def avg(*ls):
        acc = sum(l.to(torch.float32) * w[i] for i, l in enumerate(ls))
        return acc.to(ls[0].dtype)

    # tree_map raises on a structure mismatch between clients
    return tree_map(avg, *trees)
