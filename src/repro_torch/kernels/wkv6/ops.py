"""Public WKV-6 op: dispatch around the WKV-6 kernel (port of
``repro/kernels/wkv6/ops.py``).

A CUDA tensor goes through the hand-written kernel, which runs to T
exactly (the TPU op padded T to its chunk with w = 1, k = 0 steps, exact
no-ops on the state), and launches or raises.  A CPU tensor takes the
plain version (``ref.py``).  The TPU op's ``block_t`` and ``interpret``
have no counterpart here.

Forward only, as the reference: a tensor that requires grad raises on
either device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.wkv6.kernel import wkv6_kernel
from repro_torch.kernels.wkv6.ref import wkv6_ref


def wkv6(r, k, v, w, u, state0: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w: (B, T, H, N); u: (H, N) -> (out (B,T,H,N), sT (B,H,N,N))."""
    if any(t is not None and t.requires_grad
           for t in (r, k, v, w, u, state0)):
        raise RuntimeError(
            "wkv6 is forward-only: the reference kernel has no VJP; run it "
            "under torch.no_grad() or use the plain scan")
    if r.device.type == "cuda":
        return wkv6_kernel(*(t.contiguous() for t in (r, k, v, w, u)),
                           None if state0 is None else state0.contiguous())
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, w, u, state0)
    raise ValueError(f"wkv6: no path for device {r.device}")
