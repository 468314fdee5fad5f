"""The RWKV-6 WKV recurrence as a hand-written CUDA kernel
(``repro_torch/csrc/wkv6.cu``), replacing the Pallas TPU kernel
``repro/kernels/wkv6/kernel.py:wkv6_kernel``.

One CTA per (batch, head) with (N / C) x G threads (256 at N = 64: G = 16
row slices by C = 4 columns): each thread keeps an (N / G) x C block of
the N x N state in registers for the whole sequence; the G slices' partial
outputs are summed in a fixed order once a chunk of steps is done; r, k,
v, w stream through a 3-stage shared-memory ring a chunk of steps at a
time.
Runs to T exactly (the TPU op padded T with no-op steps), and the order of
every sum is independent of where T starts, so chaining two halves through
the state equals one pass bit for bit.  Forward only: the reference has no VJP for
its kernel, and neither has this one.  Built by ``nvcc`` at first use and
called through ``ctypes``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

HEAD_DIMS = (8, 16, 32, 64)                      # instantiated N


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("wkv6")
    fn = lib.wkv6_fwd_f32
    p, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 8 + [i32] * 4 + [p]
    fn.restype = ctypes.c_int
    return fn


def wkv6_kernel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor,
                state0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w: (B, T, H, N) fp32; u: (H, N) fp32; state0: (B, H, N, N)
    fp32 or None (zeros); all contiguous on one CUDA device.  Returns (out
    (B, T, H, N) fp32, final state (B, H, N, N) fp32).

    Launches on the current stream and does not synchronise.  Raises on any
    input the kernel does not take, on a tensor that requires grad (there
    is no backward), and when the launch is refused."""
    named = {"r": r, "k": k, "v": v, "w": w, "u": u}
    if state0 is not None:
        named["state0"] = state0
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_kernel needs CUDA tensors, got {r.device}")
    for name, t in named.items():
        if t.device != r.device:
            raise ValueError(f"wkv6_kernel: {name} on {t.device}, r on "
                             f"{r.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"wkv6_kernel takes float32, {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"wkv6_kernel: {name} is not contiguous")
        if t.requires_grad:
            raise RuntimeError(
                "wkv6_kernel is forward-only: the reference kernel has no "
                "VJP, so there is no backward kernel; call it under "
                "torch.no_grad() on tensors that do not require grad")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"r/k/v/w shapes {[tuple(t.shape) for t in (r, k, v, w)]}:"
                         f" need four equal (B, T, H, N)")
    b, t, h, n = r.shape
    if u.shape != (h, n):
        raise ValueError(f"u {tuple(u.shape)}, need {(h, n)}")
    if state0 is not None and state0.shape != (b, h, n, n):
        raise ValueError(f"state0 {tuple(state0.shape)}, need {(b, h, n, n)}")
    if n not in HEAD_DIMS:
        raise ValueError(f"head size {n}: the kernel is built for "
                         f"{HEAD_DIMS}")
    if min(b, t, h) == 0 or b * h >= 2 ** 31:
        raise ValueError(f"unsupported shape {tuple(r.shape)}")
    fn = _lib()
    out = torch.empty_like(r)
    sT = torch.empty((b, h, n, n), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), None if state0 is None else state0.data_ptr(),
                 out.data_ptr(), sT.data_ptr(), b, t, h, n, stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err}")
    wkv6_kernel.launches += 1
    return out, sT


# launches of the kernel in this process (a run reads it to show that its
# main path went through the kernel)
wkv6_kernel.launches = 0
