"""Input generator ``fsl_images``: synthetic images of MNIST's shape for
each client, from the run's seed and the traffic file's ``images`` block
alone, never from the program."""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from perfbench.common import subseed


def make(spec: Dict[str, Any], seed: int, clients: List[str],
         shape) -> Dict[str, np.ndarray]:
    """8-bit pixel levels in [-1, 1], a share ``background`` of them at -1
    as on MNIST's dark ground.  Speed does not depend on their content."""
    n = int(spec["images_per_client"])
    bg = float(spec["background"])
    out = {}
    for i, cid in enumerate(clients):
        rng = np.random.default_rng(subseed(seed, 1, i))
        level = rng.integers(0, 256, (n, *shape)).astype(np.float32)
        level[rng.random((n, *shape)) < bg] = 0.0
        out[cid] = level / np.float32(127.5) - np.float32(1.0)
    return out
