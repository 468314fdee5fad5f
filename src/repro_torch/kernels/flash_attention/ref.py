"""Plain PyTorch version of the flash-attention kernel (port of
``repro/kernels/flash_attention/ref.py``): what the CPU takes, and what the
CUDA kernel is held against on the GPU."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale: Optional[float] = None, q_offset: int = 0,
                  seq_k_valid: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, Hkv, Sk, D). fp32 math throughout; the
    output in q's dtype.

    ``q_offset`` is the global position of q row 0.  Keys at and beyond
    ``seq_k_valid`` (default Sk) are masked like any other, as the TPU
    kernel's valid-length mask does: a row with no unmasked key then
    averages v uniformly over all Sk keys, since every logit is the same
    finite ``NEG_INF``."""
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    groups = h // hkv
    k = torch.repeat_interleave(k, groups, dim=1)
    v = torch.repeat_interleave(v, groups, dim=1)
    scale = d ** -0.5 if scale is None else scale
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
        mask = q_pos >= k_pos
        if window > 0:
            mask &= (q_pos - k_pos) < window
    if seq_k_valid is not None:
        mask = mask & (k_pos < seq_k_valid)
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.to(torch.float32))
    return out.to(q.dtype)
