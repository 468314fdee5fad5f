"""Parameter bridge between numpy trees and the port's tensor trees.

The JAX package's parameters become numpy with ``np.asarray`` leaf by leaf;
the port keeps the same keys and leaf shapes (HWIO kernels, ``(d_in,
d_out)`` dense weights, stacked layer axes first), so crossing over is a
plain copy in both directions.

A bf16 leaf (the LM trees' ``param_dtype="bfloat16"``) is an
``ml_dtypes.bfloat16`` array on the numpy side, which ``torch.tensor``
does not take.  It crosses bit for bit as 16-bit integers: viewed as
``int16`` on the way in and reinterpreted as ``torch.bfloat16``; the way
out is the reverse.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from repro_torch.tree import tree_map


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16" and a.dtype.itemsize == 2


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if _is_bf16(a):
        return torch.tensor(a.view(np.int16), device=device).view(
            torch.bfloat16)
    return torch.tensor(a, device=device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        # numpy has no bf16 of its own: the JAX side's type comes from
        # ml_dtypes, which only this direction needs
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree, device: Union[str, torch.device]):
    """Nested dict of numpy arrays -> the same dict of tensors on
    ``device`` (copies; dtypes kept, bf16 bit for bit)."""
    return tree_map(lambda a: _to_tensor(a, device), tree)


def params_to_numpy(tree):
    """Inverse of :func:`params_from_numpy`: tensors -> numpy on the host."""
    return tree_map(_to_numpy, tree)
