"""Parameter bridge between numpy trees and the port's tensor trees.

The JAX package's parameters become numpy with ``np.asarray`` leaf by leaf;
the port keeps the same keys and leaf shapes (HWIO kernels), so crossing
over is a plain copy in both directions.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from repro_torch.tree import tree_map


def params_from_numpy(tree, device: Union[str, torch.device]):
    """Nested dict of numpy arrays -> the same dict of tensors on
    ``device`` (copies; dtypes kept)."""
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device),
                    tree)


def params_to_numpy(tree):
    """Inverse of :func:`params_from_numpy`: tensors -> numpy on the host."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
