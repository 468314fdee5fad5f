"""Weighted parameter average as a hand-written CUDA kernel
(``repro_torch/csrc/fedavg.cu``), replacing the Pallas TPU kernel
``repro/kernels/fedavg/kernel.py:fedavg_kernel``.

The reduce ``out[n] = sum_c w[c] * stacked[c, n]`` is memory-bound: one
read of the (C, N) stack and one write of N.  The kernel makes that single
pass with 16-byte loads and needs no padding copy (the TPU kernel padded N
to its tile).  The library is built by ``nvcc`` at first use and called
through ``ctypes``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("fedavg")
    fn = lib.fedavg_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fedavg_kernel(stacked: torch.Tensor, weights: torch.Tensor
                  ) -> torch.Tensor:
    """stacked: (C, N) fp32 client-major flat params on a CUDA device;
    weights: (C,) fp32 on the same device, summing to 1 -> (N,) fp32.

    Launches on the current stream of ``stacked``'s device and does not
    synchronise.  Raises on any input the kernel does not take (another
    device or dtype, a wrong shape, a non-contiguous tensor, an empty
    dimension) and when the launch is refused."""
    if stacked.device.type != "cuda":
        raise ValueError(f"fedavg_kernel needs a CUDA tensor, got "
                         f"{stacked.device}")
    if weights.device != stacked.device:
        raise ValueError(f"weights on {weights.device}, stacked on "
                         f"{stacked.device}")
    if stacked.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError(f"fedavg_kernel takes float32, got {stacked.dtype} "
                        f"and {weights.dtype}")
    if stacked.dim() != 2 or weights.shape != (stacked.shape[0],):
        raise ValueError(f"shapes {tuple(stacked.shape)} and "
                         f"{tuple(weights.shape)}: need (C, N) and (C,)")
    if not (stacked.is_contiguous() and weights.is_contiguous()):
        raise ValueError("fedavg_kernel needs contiguous tensors")
    c, n = stacked.shape
    if c == 0 or n == 0:
        raise ValueError(f"empty stack {tuple(stacked.shape)}")
    fn = _lib()
    out = torch.empty((n,), dtype=torch.float32, device=stacked.device)
    with torch.cuda.device(stacked.device):
        stream = torch.cuda.current_stream(stacked.device).cuda_stream
        err = fn(stacked.data_ptr(), weights.data_ptr(), out.data_ptr(),
                 c, n, stream)
    if err != 0:
        raise RuntimeError(f"fedavg kernel launch failed: CUDA error {err}")
    fedavg_kernel.launches += 1
    return out


# launches of the kernel in this process (a run reads it to show that its
# main path went through the kernel)
fedavg_kernel.launches = 0
