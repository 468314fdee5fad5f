"""Causal flash attention for training as hand-written CUDA kernels
(``repro_torch/csrc/flash_attention_train.cu``), with a backward.

The reference trains through plain attention: its Pallas flash kernel has
no VJP, and neither has the port's forward-only ``flash_attention`` op
beside this one.  This op is the training attention core that
``models.layers.attention`` takes for CUDA bf16 self-attention
(:func:`takes`), with or without autograd: a ``torch.autograd.Function``
whose forward keeps the row log-sum-exp and an fp32 copy of O (not
written where no gradient is asked for, as in serving's prefill), and
whose backward recomputes the probabilities tile by tile (dK and dV in
one launch, dQ in another, no atomics: the same bits every run).  Products are ``wgmma`` with bf16
operands and fp32 accumulation, P and dS are rounded to bf16 once, and
tiles that the positions' bounds show fully masked are skipped.

The mask is ``attention_scores_mask(pos, pos, window)`` for the one int64
position vector of a self-attention call, read on the device: no arange
is assumed or checked on the host.  A call is self-attention when its
query and key positions are one tensor, or views of the same memory
(:func:`shapes_ok`); equal values in distinct tensors are not compared,
since that would read them on the host, and take the plain path.
Instantiated for (Dqk, Dv) in :data:`HEAD_DIMS`: MLA's (192, 128) and
GQA's (128, 128).  Built by ``nvcc`` at first use and called through
``ctypes``.
"""
import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.kernel import _strides, tma_ok

HEAD_DIMS = ((192, 128), (128, 128))     # instantiated (Dqk, Dv)
POS_ROWS = 64                            # rows one position bound covers
PAD = 128                                # LSE / Delta rows padded to this
_MAX_GRID = 65535


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("flash_attention_train")
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.flash_train_bounds.argtypes = [p, i32, p, p, p]
    lib.flash_train_fwd.argtypes = ([p] * 6 + [i32] * 6 + [i64] * 15
                                    + [p, p, p, i32, ctypes.c_float, p])
    lib.flash_train_bwd.argtypes = ([p] * 10 + [i32] * 6 + [i64] * 24
                                    + [p, p, p, i32, ctypes.c_float, p])
    for fn in (lib.flash_train_bounds, lib.flash_train_fwd,
               lib.flash_train_bwd):
        fn.restype = ctypes.c_int
    return lib


def smem_bytes(kernel: int, dqk: int, dv: int) -> int:
    """Dynamic shared memory of one CTA of kernel 0 (forward), 1 (dK, dV)
    or 2 (dQ) at (dqk, dv) (builds the kernels if needed)."""
    fn = build.load("flash_attention_train").flash_train_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn(kernel, dqk, dv)


def takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          q_pos: torch.Tensor, k_pos: torch.Tensor,
          kv_valid: Optional[torch.Tensor]) -> bool:
    """Whether ``models.layers.attention`` sends a call to these kernels:
    q, k and v bf16 on a CUDA device, in a shape :func:`shapes_ok` takes."""
    return (q.device.type == "cuda"
            and q.dtype == k.dtype == v.dtype == torch.bfloat16
            and shapes_ok(q, k, v, q_pos, k_pos, kv_valid))


def same_positions(q_pos: torch.Tensor, k_pos: torch.Tensor) -> bool:
    """Whether the two position tensors are one: the same object, or views
    of the same memory with the same shape, strides and dtype."""
    return q_pos is k_pos or (
        q_pos.device == k_pos.device and q_pos.dtype == k_pos.dtype
        and q_pos.shape == k_pos.shape and q_pos.stride() == k_pos.stride()
        and q_pos.data_ptr() == k_pos.data_ptr())


def shapes_ok(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_pos: torch.Tensor, k_pos: torch.Tensor,
              kv_valid: Optional[torch.Tensor]) -> bool:
    """No ``kv_valid``; self-attention over one 1-d position vector
    (:func:`same_positions`, so every query sees its own key); q (B, S, H,
    Dqk), k (B, S, Hkv, Dqk), v (B, S, Hkv, Dv) with (Dqk, Dv)
    instantiated and H a multiple of Hkv (GQA)."""
    return (kv_valid is None and q_pos.dim() == 1
            and same_positions(q_pos, k_pos)
            and q.dim() == 4 and k.dim() == 4 and v.dim() == 4
            and q.shape[1] == k.shape[1] == v.shape[1] == q_pos.shape[0]
            and k.shape[:3] == v.shape[:3] and q.shape[0] == k.shape[0]
            and k.shape[-1] == q.shape[-1]
            and (q.shape[-1], v.shape[-1]) in HEAD_DIMS
            and q.shape[2] % k.shape[2] == 0
            and 0 < q.shape[0] <= _MAX_GRID and 0 < q.shape[2] <= _MAX_GRID
            and q.shape[1] > 0)


def _view(t: torch.Tensor) -> torch.Tensor:
    """``t`` (B, S, H, D) as a (B, H, S, D) view the kernels can read (d
    contiguous, address and strides as TMA takes them): copied to a fresh
    contiguous buffer when its own cannot."""
    view = t.transpose(1, 2)
    if view.stride(-1) == 1 and tma_ok(view):
        return view
    return t.clone(memory_format=torch.contiguous_format).transpose(1, 2)


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"flash_attention_train {what} launch failed: "
                           f"CUDA error {err}")


def flash_train_fwd_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, pos: torch.Tensor, window: int,
                           scale: float, keep_o32: bool = True):
    """q (B, S, H, Dqk), k (B, S, Hkv, Dqk), v (B, S, Hkv, Dv) bf16 on one
    CUDA device, pos (S,) int64 -> (o (B, S, H, Dv) bf16, o32 (B, S, H, Dv)
    fp32, lse (B, H, S_pad) fp32, bounds (2, ceil(S / 64)) int64).  Without
    ``keep_o32`` (no backward to follow) o32 is empty and not written.
    Two launches (the position bounds, the forward)."""
    b, s, h, dqk = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    qt, kt, vt = (_view(t) for t in (q, k, v))
    dev = q.device
    s_pad = -(-s // PAD) * PAD
    bounds = torch.empty((2, -(-s // POS_ROWS)), dtype=torch.int64,
                         device=dev)
    o = torch.empty((b, s, h, dv), dtype=torch.bfloat16, device=dev)
    o32 = torch.empty((b, s, h, dv) if keep_o32 else (0,),
                      dtype=torch.float32, device=dev)
    o32_ptr, o32_strides = ((o32.data_ptr(), _strides(o32.transpose(1, 2)))
                            if keep_o32 else (None, (0, 0, 0)))
    lse = torch.empty((b, h, s_pad), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check(lib.flash_train_bounds(pos.data_ptr(), s,
                                      bounds[0].data_ptr(),
                                      bounds[1].data_ptr(), stream),
               "bounds")
        _check(lib.flash_train_fwd(
            qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), o.data_ptr(),
            o32_ptr, lse.data_ptr(), dqk, dv, b, h, hkv, s,
            *_strides(qt), *_strides(kt), *_strides(vt),
            *_strides(o.transpose(1, 2)), *o32_strides,
            pos.data_ptr(), bounds[0].data_ptr(), bounds[1].data_ptr(),
            int(window), float(scale), stream), "forward")
    flash_train_fwd_kernel.launches += 1
    return o, o32, lse, bounds


def flash_train_bwd_kernel(q, k, v, o32, lse, pos, bounds, do, window: int,
                           scale: float):
    """The gradients (dq, dk, dv), each like its input in bf16, of the
    forward of :func:`flash_train_fwd_kernel` for the upstream gradient
    ``do`` (B, S, H, Dv).  Three launches (Delta, dK and dV, dQ)."""
    b, s, h, dqk = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    do = do.to(torch.bfloat16)
    qt, kt, vt, dot = (_view(t) for t in (q, k, v, do.contiguous()))
    dev = q.device
    dq = torch.empty((b, s, h, dqk), dtype=torch.bfloat16, device=dev)
    dk = torch.empty((b, s, hkv, dqk), dtype=torch.bfloat16, device=dev)
    dvv = torch.empty((b, s, hkv, dv), dtype=torch.bfloat16, device=dev)
    delta = torch.empty_like(lse)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check(lib.flash_train_bwd(
            qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), o32.data_ptr(),
            dot.data_ptr(), dq.data_ptr(), dk.data_ptr(), dvv.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dqk, dv, b, h, hkv, s,
            *_strides(qt), *_strides(kt), *_strides(vt),
            *_strides(o32.transpose(1, 2)), *_strides(dot),
            *_strides(dq.transpose(1, 2)), *_strides(dk.transpose(1, 2)),
            *_strides(dvv.transpose(1, 2)), pos.data_ptr(),
            bounds[0].data_ptr(), bounds[1].data_ptr(), int(window),
            float(scale), stream), "backward")
    flash_train_bwd_kernel.launches += 1
    return dq, dk, dvv


# launches of each wrapper in this process (a run reads them to show that
# its main path went through the kernels)
flash_train_fwd_kernel.launches = 0
flash_train_bwd_kernel.launches = 0


# The two launches as dispatcher ops, so that what counts the operations
# of a step (``FlopCounterMode``: roofline/analysis.py, the dry run's check
# against the card) sees them.  They are counted as ``FlopCounterMode``
# counts the plain path's products and PyTorch's own SDPA, causal or not:
# the full S x S square, about twice the causal work the kernels do.  The
# dry run's flop check thus matches these formulas to its plain count and
# measures nothing of the kernels.
@torch.library.custom_op("repro_torch::flash_train_fwd", mutates_args=())
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            pos: torch.Tensor, window: int, scale: float, keep_o32: bool
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]:
    return flash_train_fwd_kernel(q, k, v, pos, window, scale, keep_o32)


@torch.library.custom_op("repro_torch::flash_train_bwd", mutates_args=())
def _bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            o32: torch.Tensor, lse: torch.Tensor, pos: torch.Tensor,
            bounds: torch.Tensor, do: torch.Tensor, window: int, scale: float
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return flash_train_bwd_kernel(q, k, v, o32, lse, pos, bounds, do, window,
                                  scale)


def _square_flops(q_shape, v_shape) -> int:
    """The plain path's products in one forward: q.k^T and p.v over the
    full square."""
    b, s, h, dqk = q_shape
    return 2 * b * s * s * h * (dqk + v_shape[-1])


@register_flop_formula(torch.ops.repro_torch.flash_train_fwd)
def _fwd_flops(q_shape, k_shape, v_shape, *args, **kwargs) -> int:
    return _square_flops(q_shape, v_shape)


@register_flop_formula(torch.ops.repro_torch.flash_train_bwd)
def _bwd_flops(q_shape, k_shape, v_shape, *args, **kwargs) -> int:
    return 2 * _square_flops(q_shape, v_shape)


class FlashAttentionTrain(torch.autograd.Function):
    """Causal (optionally banded) self-attention with the kernels' backward.
    Saves q, k, v, the fp32 O, the row log-sum-exp and the position bounds
    for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, pos, window, scale):
        o, o32, lse, bounds = _fwd_op(q, k, v, pos, window, scale, True)
        ctx.save_for_backward(q, k, v, o32, lse, pos, bounds)
        ctx.window, ctx.scale = window, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o32, lse, pos, bounds = ctx.saved_tensors
        dq, dk, dv = _bwd_op(q, k, v, o32, lse, pos, bounds, do, ctx.window,
                             ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          pos: torch.Tensor, *, window: int = 0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """q (B, S, H, Dqk), k (B, S, Hkv, Dqk), v (B, S, Hkv, Dv): bf16 CUDA
    tensors that :func:`takes` accepts with ``pos`` (S,) as both position
    vectors -> (B, S, H, Dv) bf16, differentiable in q, k and v.  ``scale``
    defaults to Dqk ** -0.5.  Where no gradient is asked for (grad mode
    off, or no input that requires one), the forward runs alone and keeps
    nothing for a backward."""
    if window < 0:
        raise ValueError(f"window {window} must be >= 0")
    if not takes(q, k, v, pos, pos, None):
        raise ValueError(
            f"flash_attention_train: q {tuple(q.shape)} {q.dtype}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)} on {q.device}: needs bf16 "
            f"CUDA self-attention with (Dqk, Dv) in {HEAD_DIMS}")
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    pos = pos.to(device=q.device, dtype=torch.int64).contiguous()
    if not (torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return _fwd_op(q, k, v, pos, int(window), scale, False)[0]
    return FlashAttentionTrain.apply(q, k, v, pos, int(window), scale)
