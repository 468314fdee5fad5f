"""Plain PyTorch version of the WKV-6 kernel (port of
``repro/kernels/wkv6/ref.py``, the same math as ``models/rwkv6.py``): what
the CPU takes, and what the CUDA kernel is held against on the GPU."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def wkv6_ref(r, k, v, w, u, state0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w: (B, T, H, N); u: (H, N); state0: (B, H, N, N) or None
    (zeros) -> (out (B, T, H, N) in r's dtype, final state (B, H, N, N)
    fp32).  A loop over time: kv, then the output from the old state, then
    the update."""
    b, t, h, n = r.shape
    S = (torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
         if state0 is None else state0.to(torch.float32))
    r32, k32, v32, w32 = (a.to(torch.float32) for a in (r, k, v, w))
    u32 = u.to(torch.float32)[None, :, :, None]
    outs = []
    for i in range(t):
        kv = k32[:, i, :, :, None] * v32[:, i, :, None, :]   # (B,H,n,n)
        outs.append(torch.einsum("bhn,bhnm->bhm", r32[:, i], S + u32 * kv))
        S = w32[:, i, :, :, None] * S + kv
    return torch.stack(outs, dim=1).to(r.dtype), S
