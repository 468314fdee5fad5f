"""Federated data partitioning (numpy copy of ``repro/data/federated.py``):
Dirichlet non-IID label skew.

The paper notes (Fig 4) that multiple discriminators "preserve the
heterogeneity of the data distributions" — the Dirichlet partitioner is how
that heterogeneity is produced in the reproduction.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def partition_dirichlet(data: np.ndarray, labels: np.ndarray,
                        num_clients: int, alpha: float = 0.5, seed: int = 0
                        ) -> Dict[str, np.ndarray]:
    """Label-skewed split: client k's label distribution ~ Dir(alpha)."""
    rng = np.random.default_rng(seed)
    by_label: Dict[int, np.ndarray] = {
        int(l): np.where(labels == l)[0] for l in np.unique(labels)}
    client_idx: List[List[int]] = [[] for _ in range(num_clients)]
    for l, idx in by_label.items():
        idx = rng.permutation(idx)
        props = rng.dirichlet([alpha] * num_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for k, chunk in enumerate(np.split(idx, cuts)):
            client_idx[k].extend(chunk.tolist())
    out = {}
    for k in range(num_clients):
        sel = np.asarray(sorted(client_idx[k]), int)
        if len(sel) == 0:                 # guarantee non-empty clients
            sel = np.asarray([int(rng.integers(0, len(data)))])
        out[f"c{k}"] = data[sel]
    return out
