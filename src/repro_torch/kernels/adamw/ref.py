"""Plain PyTorch AdamW of one leaf (the port's eager form of
``repro/optim``): what the CPU takes, after the optimizer's global-norm
clip, and what the CUDA kernels are held against on the GPU.  Written out
exactly as the reference computes: fp32 moments, the same order of
operations."""
from __future__ import annotations

from typing import Tuple

import torch


def adamw_ref(g, m, v, p, bc1, bc2, lr, *, beta1: float, beta2: float,
              eps: float, weight_decay: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One AdamW step of a leaf: ``g`` the (clipped) gradient, ``bc1``,
    ``bc2`` the bias corrections ``1 - beta^t`` -> ``(p', m', v')`` in
    ``p``'s, ``m``'s and ``v``'s dtypes; the inputs are not written."""
    g32 = g.to(torch.float32)
    m32 = beta1 * m.to(torch.float32) + (1 - beta1) * g32
    v32 = beta2 * v.to(torch.float32) + (1 - beta2) * g32 * g32
    mh = m32 / bc1
    vh = v32 / bc2
    delta = mh / (torch.sqrt(vh) + eps)
    if weight_decay:
        delta = delta + weight_decay * p.to(torch.float32)
    newp = p.to(torch.float32) - lr * delta
    return (newp.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype))
