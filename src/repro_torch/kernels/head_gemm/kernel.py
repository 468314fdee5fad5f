"""The fp32 LM head's split-bf16 products as hand-written CUDA kernels
(``repro_torch/csrc/head_gemm.cu``), called through ``ctypes``.

:func:`head_split_kernel` writes an fp32 matrix's three bf16 parts (hi,
mid, lo: ``ref.split3``); :func:`head_fwd_kernel`, :func:`head_dw_kernel`
and :func:`head_dx_kernel` multiply parts on the tensor cores with fp32
accumulation: the forward x.w, dW = x^T.G and dX = G.w^T.  Each wrapper
checks what its kernel takes, allocates the output, launches on the
current stream and counts its launches (``launches``).  Built by ``nvcc``
at first use.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_KINDS = {"fwd": 0, "dw": 1, "dx": 2}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("head_gemm")
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.head_split.argtypes = [p, i64, i64, i64, p, p]
    lib.head_gemm.argtypes = ([i32, p, i64, i64, p, i64, i64, p, i64]
                              + [i32] * 3 + [p])
    lib.head_gemm_smem_bytes.argtypes = [i32]
    for fn in (lib.head_split, lib.head_gemm, lib.head_gemm_smem_bytes):
        fn.restype = ctypes.c_int
    return lib


def smem_bytes(kind: str) -> int:
    """Dynamic shared memory of one CTA of the GEMM ``kind`` (``fwd``,
    ``dw``, ``dx``); builds the kernels if needed."""
    return _lib().head_gemm_smem_bytes(_KINDS[kind])


def tma_ok(t: torch.Tensor) -> bool:
    """Whether a bf16 operand (rows, cols) or parts (3, rows, cols) can be
    read in place by TMA: the last dimension contiguous, the other strides
    multiples of 16 bytes, the address 16-byte aligned."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s * t.element_size() % 16 == 0 for s in t.stride()[:-1]))


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"head_gemm {what} launch failed: CUDA error "
                           f"{err}")


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"head_gemm: {what}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def head_split_kernel(t: torch.Tensor) -> torch.Tensor:
    """fp32 ``t`` (rows, cols) on a CUDA device, cols a multiple of 8 ->
    its parts (3, rows, cols) bf16: hi, mid, lo.  One launch."""
    _require(t.device.type == "cuda" and t.dtype == torch.float32
             and t.dim() == 2 and t.shape[1] % 8 == 0,
             f"split takes fp32 (rows, cols % 8 == 0) on CUDA, got "
             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not (t.stride(1) == 1 and t.stride(0) % 4 == 0
            and t.data_ptr() % 16 == 0):
        t = t.contiguous()
    rows, cols = t.shape
    out = torch.empty((3, rows, cols), dtype=torch.bfloat16, device=t.device)
    if t.numel():
        with torch.cuda.device(t.device):
            _check(_lib().head_split(t.data_ptr(), rows, cols, t.stride(0),
                                     out.data_ptr(), _stream(t)), "split")
        head_split_kernel.launches += 1
    return out


def _gemm(kind: str, a: torch.Tensor, b: torch.Tensor, m: int, n: int,
          k: int) -> torch.Tensor:
    """out (m, n) fp32 of the GEMM ``kind`` over bf16 operands ``a`` and
    ``b`` (each 2-d, or parts (3, rows, cols)), read by their strides."""
    _require(a.device == b.device and a.device.type == "cuda"
             and a.dtype == b.dtype == torch.bfloat16,
             f"{kind} takes bf16 operands on one CUDA device, got {a.dtype} "
             f"on {a.device}, {b.dtype} on {b.device}")
    a, b = (t if tma_ok(t) else t.contiguous() for t in (a, b))

    def strides(t):
        return (t.stride(-2), t.stride(0) if t.dim() == 3 else 0)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        _check(_lib().head_gemm(_KINDS[kind], a.data_ptr(), *strides(a),
                                b.data_ptr(), *strides(b), out.data_ptr(),
                                out.stride(0), m, n, k, _stream(a)), kind)
    return out


def head_fwd_kernel(x: torch.Tensor, w_parts: torch.Tensor) -> torch.Tensor:
    """x (M, K) bf16, w's parts (3, K, N) -> x.w (M, N) fp32, the three
    terms x.lo + x.mid + x.hi.  One launch."""
    m, k = x.shape
    _require(w_parts.dim() == 3 and w_parts.shape[:2] == (3, k),
             f"forward: x {tuple(x.shape)}, w parts {tuple(w_parts.shape)}")
    out = _gemm("fwd", x, w_parts, m, w_parts.shape[2], k)
    head_fwd_kernel.launches += 1
    return out


def head_dw_kernel(x: torch.Tensor, g_parts: torch.Tensor) -> torch.Tensor:
    """x (T, D) bf16, G's parts (3, T, N) -> x^T.G (D, N) fp32, three
    terms.  One launch."""
    t, d = x.shape
    _require(g_parts.dim() == 3 and g_parts.shape[:2] == (3, t),
             f"dW: x {tuple(x.shape)}, G parts {tuple(g_parts.shape)}")
    out = _gemm("dw", x, g_parts, d, g_parts.shape[2], t)
    head_dw_kernel.launches += 1
    return out


def head_dx_kernel(g_parts: torch.Tensor, w_parts: torch.Tensor
                   ) -> torch.Tensor:
    """G's parts (3, T, N), w's parts (3, D, N) -> G.w^T (T, D) fp32, the
    six pairs of parts whose products reach fp32's 24 bits
    (``ref.TERMS["dx"]``).  One launch."""
    _require(g_parts.dim() == w_parts.dim() == 3
             and g_parts.shape[0] == w_parts.shape[0] == 3
             and g_parts.shape[2] == w_parts.shape[2],
             f"dX: G parts {tuple(g_parts.shape)}, w parts "
             f"{tuple(w_parts.shape)}")
    out = _gemm("dx", g_parts, w_parts, g_parts.shape[1], w_parts.shape[1],
                g_parts.shape[2])
    head_dx_kernel.launches += 1
    return out


# launches of each wrapper in this process (a run reads them to show that
# its main path went through the kernels)
head_split_kernel.launches = 0
head_fwd_kernel.launches = 0
head_dw_kernel.launches = 0
head_dx_kernel.launches = 0
