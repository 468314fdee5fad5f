"""Public flash-attention op: layout glue around the flash-attention kernel
(port of ``repro/kernels/flash_attention/ops.py``).

Takes model-layout tensors (B, S, H, D), as the attention blocks produce
them.  A CUDA tensor goes through the hand-written kernel, which reads the
(B, S, H, D) buffers through transposed views and writes its output the
same way, so nothing is padded or copied (the TPU op padded S to its block
and transposed); it launches or raises.  A CPU tensor takes the plain
version (``ref.py``).  The TPU op's block sizes and ``interpret`` switch
have no counterpart here: the kernel fixes its own tiles (bf16: 128 q rows
by 128 keys on the tensor cores; fp32: 64 by 64).

Forward only, as the reference: a tensor that requires grad raises on
either device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, Hkv, D) -> (B, Sq, H, D)."""
    if any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention is forward-only: the reference kernel has no "
            "VJP; run it under torch.no_grad() or use the plain attention")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if q.device.type == "cuda":
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        flash_attention_kernel(qt, kt, vt, causal=causal, window=window,
                               out=out.transpose(1, 2))
        return out
    if q.device.type == "cpu":
        return attention_ref(qt, kt, vt, causal=causal,
                             window=window).transpose(1, 2)
    raise ValueError(f"flash_attention: no path for device {q.device}")
