"""Fused boundary stage (codec qdq + per-example clip + noise) as a
hand-written CUDA kernel (``repro_torch/csrc/boundary_fuse.cu``), replacing
the Pallas TPU kernel
``repro/kernels/boundary_fuse/kernel.py:boundary_fuse_kernel``.

One CTA per example row: qdq, the row's squared norm, then
``q * min(1, C / ||q_b||) + s * z`` — one read of x and z from device
memory and one write.  For int8 a first small launch takes the whole
tensor's amax.  Built by ``nvcc`` at first use and called through
``ctypes``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.boundary_fuse.ref import CODECS

_AMAX_BLOCKS = 256      # kAmaxBlocks in boundary_fuse.cu


@functools.lru_cache(maxsize=None)
def _lib():
    fn = build.load("boundary_fuse").boundary_fuse_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_float, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def boundary_fuse_kernel(x: torch.Tensor, clip: float, noise_scale: float,
                         noise: torch.Tensor, *, codec: str = "none"
                         ) -> torch.Tensor:
    """x: (B, N) fp32 flattened boundary tensor on a CUDA device; noise:
    (B, N) fp32 on the same device -> (B, N) fp32.

    Launches on the current stream of ``x``'s device and does not
    synchronise.  Raises on any input the kernel does not take (another
    device or dtype, mismatched shapes, a non-contiguous tensor, an empty
    dimension, an unknown codec) and when a launch is refused."""
    if codec not in CODECS:
        raise ValueError(f"unknown fusable codec {codec!r}")
    if x.device.type != "cuda":
        raise ValueError(f"boundary_fuse_kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if noise.device != x.device:
        raise ValueError(f"noise on {noise.device}, x on {x.device}")
    if x.dtype != torch.float32 or noise.dtype != torch.float32:
        raise TypeError(f"boundary_fuse_kernel takes float32, got "
                        f"{x.dtype} and {noise.dtype}")
    if x.dim() != 2 or noise.shape != x.shape:
        raise ValueError(f"shapes {tuple(x.shape)} and "
                         f"{tuple(noise.shape)}: need two equal (B, N)")
    if not (x.is_contiguous() and noise.is_contiguous()):
        raise ValueError("boundary_fuse_kernel needs contiguous tensors")
    b, n = x.shape
    if b == 0 or n == 0:
        raise ValueError(f"empty tensor {tuple(x.shape)}")
    fn = _lib()
    out = torch.empty_like(x)
    partial = torch.empty((_AMAX_BLOCKS,), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), noise.data_ptr(), partial.data_ptr(),
                 out.data_ptr(), b, n, CODECS.index(codec), float(clip),
                 float(noise_scale), stream)
    if err != 0:
        raise RuntimeError(
            f"boundary_fuse kernel launch failed: CUDA error {err}")
    boundary_fuse_kernel.launches += 1
    return out


# calls of the kernel in this process (a run reads it to show that its
# main path went through the kernel)
boundary_fuse_kernel.launches = 0
