"""Plain PyTorch versions of the agg_fuse kernels (port of
``repro/kernels/agg_fuse/ref.py``): what the CPU takes, and what the CUDA
kernels are held against on the GPU.

Coefficients are fp32 products ``fp32(w) * fp32(s)``, as in the
reference.  ``weight`` is a Python number; ``scale`` is a 0-dim fp32
tensor (an int8 wire's scale, left on its device) or a Python number.
"""
from __future__ import annotations

import numpy as np
import torch


def f32(x: float) -> float:
    """``x`` rounded to the nearest fp32 value (still a Python float, so
    PyTorch casts it to fp32 exactly)."""
    return float(np.float32(x))


def dequant_reduce_ref(wires: torch.Tensor, coefs: torch.Tensor
                       ) -> torch.Tensor:
    """(C, N) wire-dtype rows, (C, 2) fp32 ``[weight, scale]`` -> (N,) fp32
    weighted sum of the dequantized rows."""
    coef = (coefs[:, 0] * coefs[:, 1]).to(torch.float32)
    return torch.sum(wires.to(torch.float32) * coef[:, None], dim=0)


def dequant_acc_ref(acc: torch.Tensor, wire: torch.Tensor, weight,
                    scale) -> torch.Tensor:
    """One streamed fold: ``acc + (w * s) * dequant(wire)`` (a new
    tensor)."""
    coef = f32(weight) * (scale if isinstance(scale, torch.Tensor)
                          else f32(scale))
    return acc + coef * wire.to(torch.float32)


def scatter_acc_ref(acc: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                    weight) -> torch.Tensor:
    """Sparse fold: weighted top-k values added at ``idx`` by
    ``index_add`` (colliding indices sum; indices outside ``[0, N)`` are
    dropped, as the kernels drop them).  Returns a new tensor."""
    n = acc.shape[0]
    ok = (idx >= 0) & (idx < n)
    contrib = torch.where(ok, f32(weight) * vals.to(torch.float32), 0.0)
    return acc.index_add(0, torch.where(ok, idx, 0), contrib)
