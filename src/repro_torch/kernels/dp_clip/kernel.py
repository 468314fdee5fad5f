"""DP-SGD clip-sum-noise as a hand-written CUDA kernel
(``repro_torch/csrc/dp_clip.cu``), replacing the Pallas TPU kernel
``repro/kernels/dp_clip/kernel.py:dp_clip_noise_kernel``.

``out[n] = sum_b min(1, C / max(||g_b||, 1e-12)) * g[b, n] + s * z[n]``
over a (B, N) stack of per-example gradients.  Memory-bound: the kernel
reads the stack twice (the norms must be complete before the sum
starts), less what the second read finds in L2, z once, and writes N.
Three launches on one stream: a persistent row pass that streams the
stack through a shared-memory ring by TMA bulk copies and writes one
partial sum of squares a (row, span); the per-row scales, each a
fixed-order sum of its partials; a persistent column pass over tiles of
columns that sums the rows in order.  No float atomics: the same bits on
every run.  Any N and any contiguous stack take the same path.  Built by ``nvcc`` at first use and called through
``ctypes``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("dp_clip")
    fn = lib.dp_clip_noise_f32
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [p] * 4 + [i64, i64, ctypes.c_float, ctypes.c_float, p]
    fn.restype = ctypes.c_int
    work = lib.dp_clip_work_floats
    work.argtypes = [i64, i64]
    work.restype = i64
    return fn, work


def dp_clip_noise_kernel(stacked: torch.Tensor, clip: float,
                         noise_scale: float, noise: torch.Tensor
                         ) -> torch.Tensor:
    """stacked: (B, N) fp32 per-example gradients on a CUDA device; noise:
    (N,) fp32 on the same device -> (N,) fp32.

    Launches on the current stream of ``stacked``'s device and does not
    synchronise.  Raises on any input the kernel does not take (another
    device or dtype, a wrong shape, a non-contiguous tensor, an empty
    dimension) and when a launch is refused."""
    if stacked.device.type != "cuda":
        raise ValueError(f"dp_clip_noise_kernel needs a CUDA tensor, got "
                         f"{stacked.device}")
    if noise.device != stacked.device:
        raise ValueError(f"noise on {noise.device}, stacked on "
                         f"{stacked.device}")
    if stacked.dtype != torch.float32 or noise.dtype != torch.float32:
        raise TypeError(f"dp_clip_noise_kernel takes float32, got "
                        f"{stacked.dtype} and {noise.dtype}")
    if stacked.dim() != 2 or noise.shape != (stacked.shape[1],):
        raise ValueError(f"shapes {tuple(stacked.shape)} and "
                         f"{tuple(noise.shape)}: need (B, N) and (N,)")
    if not (stacked.is_contiguous() and noise.is_contiguous()):
        raise ValueError("dp_clip_noise_kernel needs contiguous tensors")
    b, n = stacked.shape
    if b == 0 or n == 0:
        raise ValueError(f"empty stack {tuple(stacked.shape)}")
    fn, work_floats = _lib()
    out = torch.empty((n,), dtype=torch.float32, device=stacked.device)
    work = torch.empty((work_floats(b, n),), dtype=torch.float32,
                       device=stacked.device)
    with torch.cuda.device(stacked.device):
        stream = torch.cuda.current_stream(stacked.device).cuda_stream
        err = fn(stacked.data_ptr(), noise.data_ptr(), work.data_ptr(),
                 out.data_ptr(), b, n, float(clip), float(noise_scale),
                 stream)
    if err != 0:
        raise RuntimeError(f"dp_clip kernel launch failed: CUDA error {err}")
    dp_clip_noise_kernel.launches += 1
    return out


# calls of the kernel in this process (a run reads it to show that its
# main path went through the kernel)
dp_clip_noise_kernel.launches = 0
