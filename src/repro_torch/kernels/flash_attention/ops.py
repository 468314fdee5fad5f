"""Public flash-attention op: layout glue around the flash-attention kernel
(port of ``repro/kernels/flash_attention/ops.py``).

Takes model-layout tensors (B, S, H, D), as the attention blocks produce
them, with any head_dim up to 256.  A CUDA tensor goes through the
hand-written kernel, which reads the (B, S, H, D) buffers through
transposed views and writes its output the same way, so the sequence is
never padded (the TPU op padded S to its block and transposed); it
launches or raises.  Two things the kernel does not take are made here:
a head_dim it is not instantiated for is zero-padded to the next one
(:func:`pad_head_dim`), and a bf16 operand of the tensor-core path whose
address or strides TMA cannot take (``kernel.tma_ok``) is copied to a
fresh contiguous buffer.  A CPU tensor takes the plain version
(``ref.py``).  The TPU op's block sizes and ``interpret`` switch have no
counterpart here: the kernel fixes its own tiles (bf16, on the tensor
cores: 128 q rows by 128 keys, 64 keys at D = 256; fp32: 64 by 64).

Forward only, as the reference: a tensor that requires grad raises on
either device.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.kernel import (HEAD_DIMS,
                                                        flash_attention_kernel,
                                                        on_tensor_cores,
                                                        tma_ok)
from repro_torch.kernels.flash_attention.ref import attention_ref


def padded_head_dim(d: int) -> int:
    """The instantiated head_dim that a head_dim ``d`` is padded to."""
    for size in HEAD_DIMS:
        if d <= size:
            return size
    raise ValueError(f"head_dim {d}: the flash kernel takes at most "
                     f"{HEAD_DIMS[-1]}")


def pad_head_dim(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            float, int]:
    """Zero-pad q, k and v along their last dimension D to
    :func:`padded_head_dim` -> (q, k, v, scale, D).  ``scale`` is the
    original D's 1/sqrt(D), to be passed to the kernel explicitly.  The
    zero columns add exactly 0 to every score, and the padded columns of v
    only make output columns that are sliced off, so attention over the
    padded tensors, sliced back to D, is the reference's.  Tensors of an
    instantiated D come back as they are."""
    d = q.shape[-1]
    size = padded_head_dim(d)
    if size != d:
        q, k, v = (F.pad(t, (0, size - d)) for t in (q, k, v))
    return q, k, v, d ** -0.5, d


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` (B, S, H, D) as a (B, H, S, D) view TMA can take: copied to a
    fresh contiguous buffer when its own address or strides cannot."""
    view = t.transpose(1, 2)
    if tma_ok(view):
        return view
    return t.clone(memory_format=torch.contiguous_format).transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, Hkv, D), D <= 256 -> (B, Sq, H, D)."""
    if any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention is forward-only: the reference kernel has no "
            "VJP; run it under torch.no_grad() or use the plain attention")
    if q.device.type == "cuda":
        qp, kp, vp, scale, d = pad_head_dim(q, k, v)
        if on_tensor_cores(q.dtype):
            qt, kt, vt = (_tma_ready(t) for t in (qp, kp, vp))
        else:
            qt, kt, vt = (t.transpose(1, 2) for t in (qp, kp, vp))
        out = torch.empty(qp.shape, dtype=q.dtype, device=q.device)
        flash_attention_kernel(qt, kt, vt, causal=causal, window=window,
                               scale=scale, out=out.transpose(1, 2))
        return out if out.shape[-1] == d else out[..., :d]
    if q.device.type == "cpu":
        return attention_ref(*(t.transpose(1, 2) for t in (q, k, v)),
                             causal=causal, window=window).transpose(1, 2)
    raise ValueError(f"flash_attention: no path for device {q.device}")
