"""Flash attention as a hand-written CUDA kernel
(``repro_torch/csrc/flash_attention.cu``), replacing the Pallas TPU kernel
``repro/kernels/flash_attention/kernel.py:flash_attention_kernel``.

Blockwise online softmax with GQA (K/V never repeated), causal,
sliding-window and valid-length masks, fully masked kv blocks skipped.
Instantiated for head_dim 32, 64, 128 and 256; the op pads any other
head_dim up to one of them.  The route is chosen by dtype alone
(:func:`on_tensor_cores`).  bf16 runs on the tensor cores at every
head_dim: one CTA per (q tile of 128 rows, head, batch), ``wgmma``
products, K/V tiles fed by TMA through a 2-stage ring (:data:`TC_BLOCK_K`
keys: 128 up to D = 128, 64 at D = 256, where O takes 128 registers a
thread), P kept in registers as a bf16 high part and residual.  fp32 runs
on the CUDA cores in fp32 (q blocks of 64), since TF32 would miss the
fp32 pin.  The kernel reads every operand by its strides (d contiguous),
so a ``(B, S, H, D)`` tensor transposed to ``(B, H, S, D)`` is read in
place; TMA needs bf16 q, k, v on 16-byte-aligned addresses with strides
of multiples of 16 bytes (:func:`tma_ok`), and the wrapper raises on any
other.  Forward only: the reference has no VJP for its kernel, and
neither has this one.  Built by ``nvcc`` at first use and called through
``ctypes``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # dtype codes of the source
HEAD_DIMS = (32, 64, 128, 256)                   # instantiated D
# keys a kv block of the tensor-core kernel, by D (the source's
# Tile<D>::kBlockK, which flash_attention_tc_block_k reports)
TC_BLOCK_K = {32: 128, 64: 128, 128: 128, 256: 64}
_MAX_GRID_YZ = 65535


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = ([p, p, p, p, i32, i32] + [i32] * 6 + [i64] * 12
                   + [i32, i32, i32, ctypes.c_float, p])
    fn.restype = ctypes.c_int
    return fn


def on_tensor_cores(dtype: torch.dtype) -> bool:
    """Whether ``dtype`` takes the source's tensor-core kernel (bf16:
    ``wgmma`` and TMA, operands as :func:`tma_ok` says) at every
    instantiated head_dim; fp32 takes the CUDA-core kernel."""
    return dtype == torch.bfloat16


def tc_block_k(head_dim: int) -> int:
    """Keys a kv block of the built tensor-core kernel at ``head_dim``
    (builds the kernel if needed)."""
    fn = build.load("flash_attention").flash_attention_tc_block_k
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(head_dim)


def smem_bytes(dtype: torch.dtype, head_dim: int) -> int:
    """Dynamic shared memory one CTA of the kernel takes for ``dtype`` and
    ``head_dim`` (builds the kernel if needed)."""
    fn = build.load("flash_attention").flash_attention_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(DTYPES[dtype], head_dim)


def _strides(t: torch.Tensor):
    sb, sh, ss, sd = t.stride()
    if sd != 1:
        raise ValueError(f"flash_attention_kernel: the last dimension must "
                         f"be contiguous, strides {t.stride()}")
    return sb, sh, ss


def tma_ok(t: torch.Tensor, align: int = 16) -> bool:
    """Whether a (B, H, S, D) operand's address and (b, h, s) strides are
    multiples of ``align`` bytes: what the tensor-core path's TMA loads
    (16) and bf16x2 stores (4) need."""
    nbytes = t.element_size()
    return (t.data_ptr() % align == 0
            and all((s * nbytes) % align == 0 for s in t.stride()[:3]))


def _check_tma(name: str, t: torch.Tensor, align: int) -> None:
    """bf16 operands of the tensor-core path go through TMA (q, k, v:
    16-byte-aligned base and strides) or bf16x2 stores (out: 4 bytes)."""
    if not tma_ok(t, align):
        raise ValueError(
            f"flash_attention_kernel: bf16 {name} needs a {align}-byte-"
            f"aligned address and (b, h, s) strides of multiples of "
            f"{align} bytes; got address {t.data_ptr():#x}, strides "
            f"{t.stride()}")


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           window: int = 0, scale: Optional[float] = None,
                           seq_k_valid: Optional[int] = None,
                           q_offset: int = 0,
                           out: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, Hkv, Sk, D), H % Hkv == 0, D in
    ``HEAD_DIMS``, all fp32 or all bf16 on one CUDA device, any strides
    with the last dimension contiguous (bf16: what TMA takes, see the
    module's note).  Returns
    (B, H, Sq, D) in q's dtype, written into ``out`` when given (any such
    strided view, e.g. a transposed ``(B, S, H, D)`` buffer).

    ``q_offset`` is the global position of q row 0; keys at and beyond
    ``seq_k_valid`` (default Sk) are masked.  Launches on the current
    stream and does not synchronise.  Raises on any input the kernel does
    not take, on a tensor that requires grad (there is no backward), and
    when the launch is refused."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_kernel needs CUDA tensors, got "
                         f"{q.device}")
    for name, t in (("k", k), ("v", v)) + ((("out", out),) if out is not None
                                          else ()):
        if t.device != q.device:
            raise ValueError(f"flash_attention_kernel: {name} on {t.device},"
                             f" q on {q.device}")
    if any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_kernel is forward-only: the reference kernel "
            "has no VJP, so there is no backward kernel; call it under "
            "torch.no_grad() on tensors that do not require grad")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_kernel takes float32 or bfloat16 "
                        f"alike, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}: need (B, H, Sq, D) and equal "
                         f"(B, Hkv, Sk, D)")
    b, h, sq, d = q.shape
    _, hkv, sk, dk = k.shape
    if k.shape[0] != b or dk != d or hkv == 0 or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do "
                         f"not pair (batch, head_dim, H % Hkv)")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d}: the kernel is built for "
                         f"{HEAD_DIMS}")
    if min(b, h, sq, sk) == 0 or b > _MAX_GRID_YZ or h > _MAX_GRID_YZ:
        raise ValueError(f"unsupported sizes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if window < 0 or q_offset < 0:
        raise ValueError(f"window {window} and q_offset {q_offset} must be "
                         f">= 0")
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    elif out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError(f"out {tuple(out.shape)} {out.dtype}, need "
                         f"{tuple(q.shape)} {q.dtype}")
    strides = (*_strides(q), *_strides(k), *_strides(v), *_strides(out))
    if on_tensor_cores(q.dtype):
        for name, t in (("q", q), ("k", k), ("v", v)):
            _check_tma(name, t, 16)
        _check_tma("out", out, 4)
    scale = d ** -0.5 if scale is None else float(scale)
    skv = sk if seq_k_valid is None else int(seq_k_valid)
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 DTYPES[q.dtype], d, b, h, hkv, sq, sk, skv, *strides,
                 int(bool(causal)), int(window), int(q_offset), scale,
                 stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_kernel.launches += 1
    return out


# launches of the kernel in this process (a run reads it to show that its
# main path went through the kernel)
flash_attention_kernel.launches = 0
