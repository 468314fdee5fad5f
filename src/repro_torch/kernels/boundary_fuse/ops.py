"""Public fused-boundary op (port of ``repro/kernels/boundary_fuse/ops.py``):
the single entry point ``core/split.FusedBoundaryStage`` calls per
crossing.

With ``use_kernel`` a CUDA tensor goes through the hand-written kernel,
which launches or raises; a CPU tensor takes the plain version
(``ref.py``), as does a CUDA tensor when the caller did not ask for the
kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.boundary_fuse.kernel import boundary_fuse_kernel
from repro_torch.kernels.boundary_fuse.ref import fused_boundary_ref


def fused_boundary_flat(x: torch.Tensor, clip, noise_scale,
                        noise: torch.Tensor, *, codec: str = "none",
                        amax: str = "tensor",
                        use_kernel: bool = False) -> torch.Tensor:
    """x: (B, N) flattened boundary tensor -> (B, N) f32 staged release
    (codec qdq, per-example clip to ``clip``, plus
    ``noise_scale * noise``).  ``amax="row"`` gives each example its own
    int8 scale, what the reference computes per example under
    ``jax.vmap``; the default takes one over the whole tensor."""
    if x.device.type == "cuda" and use_kernel:
        return boundary_fuse_kernel(x, float(clip), float(noise_scale),
                                    noise, codec=codec, amax=amax)
    if x.device.type in ("cpu", "cuda"):
        return fused_boundary_ref(x, clip, noise_scale, noise, codec=codec,
                                  amax=amax)
    raise ValueError(f"fused_boundary_flat: no path for device {x.device}")
