"""Plain PyTorch version of the fused boundary stage (port of
``repro/kernels/boundary_fuse/ref.py``): what the CPU takes, and what the
CUDA kernel is held against on the GPU.

One traversal computing what the unfused ``CodecBoundaryStage`` ->
``GaussianBoundaryStage`` chain computes over a flattened ``(B, N)``
boundary tensor:

    q      = qdq(x)                      # codec quantize/dequantize
    norms  = ||q_b||_2                   # per example
    out    = q * min(1, C/norms) + noise_scale * noise

The qdq formulas are the codecs' own (``fed/transport``), so the fused
stage equals the composed one.  Noise is an input, drawn by the caller.
"""
from __future__ import annotations

import torch

from repro_torch.fed.transport import int8_round, int8_scale, int8_scale_of

NORM_EPS = 1e-12      # all-zero-example guard, shared with kernels/dp_clip

CODECS = ("none", "fp16", "int8")
AMAX_MODES = ("tensor", "row")   # where the int8 scale's amax is taken


def int8_row_scale(x: torch.Tensor) -> torch.Tensor:
    """(B, 1) int8 scales of a (B, N) tensor, one a row: ``int8_scale`` of
    each row (a NaN makes its own row's scale 1.0)."""
    return int8_scale_of(torch.amax(torch.abs(x), dim=1, keepdim=True))


def codec_qdq(x: torch.Tensor, codec: str, amax: str = "tensor"
              ) -> torch.Tensor:
    """Elementwise quantize/dequantize of fp32 ``x``, the transport codecs'
    arithmetic.  The int8 amax is over the whole tensor (one boundary
    tensor is one codec leaf) or, with ``amax="row"``, over each row of a
    (B, N) ``x`` (each example its own leaf)."""
    if amax not in AMAX_MODES:
        raise ValueError(f"unknown amax mode {amax!r} (expected one of "
                         f"{AMAX_MODES})")
    if codec in ("none", "identity", ""):
        return x
    if codec == "fp16":
        return x.to(torch.float16).to(x.dtype)
    if codec == "int8":
        scale = int8_row_scale(x) if amax == "row" else int8_scale(x)
        return int8_round(x, scale) * scale
    raise ValueError(f"unknown fusable codec {codec!r} "
                     f"(expected one of {CODECS})")


def fused_boundary_ref(x: torch.Tensor, clip, noise_scale,
                       noise: torch.Tensor, *, codec: str = "none",
                       amax: str = "tensor") -> torch.Tensor:
    """x: (B, N) f32; noise: (B, N) f32.  -> (B, N) f32."""
    x = x.to(torch.float32)
    q = codec_qdq(x, codec, amax)
    norms = torch.linalg.vector_norm(q, dim=1)
    scale = torch.clamp(clip / torch.clamp(norms, min=NORM_EPS), max=1.0)
    return q * scale[:, None] + float(noise_scale) * noise
