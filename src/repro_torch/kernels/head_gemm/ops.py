"""The LM head's vocabulary projection ``x @ w`` (bf16 activations, an
fp32 weight, fp32 logits) on the tensor cores, differentiable in both.

``models.layers._f32_matmul`` sends a call here when :func:`takes` says
so: both on CUDA, x bf16 and w fp32, at least :data:`MIN_ROWS` rows, the
widths multiples of 8 (TMA's 16-byte rows of bf16 parts) and w's rows
contiguous (the tied unembedding's transposed table is not:
:func:`shapes_ok`).  Every other call keeps the plain form,
:func:`head_matmul_plain`.

The forward splits w into three bf16 parts and sums x times each (the
kernel's note, ``csrc/head_gemm.cu``); the backward splits the logits'
gradient G and w, and computes dX = G.w^T (six terms) and dW = x^T.G
(three).  dX leaves in fp32 and autograd casts it to x's dtype, as the
plain form's ``.to(torch.float32)`` does; dW is fp32 like w.  The splits
are written where they are needed and dropped after the products: G's
parts are 1.5x G's bytes, w's 1.5x w's.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.head_gemm.kernel import (head_dw_kernel,
                                                  head_dx_kernel,
                                                  head_fwd_kernel,
                                                  head_split_kernel)

# the fewest rows of x that take the kernels: below them the split of w,
# which costs the same at any row count, outweighs the products' gain (at
# DeepSeek-V2-Lite's widths, d 2048 and vocab 102,400, on an H100: the
# split and the kernel 1.209 ms against the plain form's 1.245 at 128
# rows, 1.267 against 2.344 at 256); decode and last-token prefill stay
# plain
MIN_ROWS = 256


def head_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with both operands in fp32: the reference's
    ``preferred_element_type=float32`` contraction (a product of two bf16
    values is exact in fp32)."""
    return x.to(torch.float32) @ w.to(torch.float32)


def takes(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether ``x @ w`` goes through the kernels: both on one CUDA device
    and in a shape :func:`shapes_ok` takes."""
    return (x.device.type == "cuda" and w.device == x.device
            and shapes_ok(x, w))


def shapes_ok(x: torch.Tensor, w: torch.Tensor) -> bool:
    """bf16 x (..., K) with at least :data:`MIN_ROWS` rows, fp32 w (K, N)
    with contiguous rows, K and N multiples of 8."""
    return (x.dtype == torch.bfloat16 and w.dtype == torch.float32
            and x.dim() >= 1 and w.dim() == 2 and x.shape[-1] == w.shape[0]
            and x.shape[-1] % 8 == 0 and w.shape[1] % 8 == 0
            and w.stride(1) == 1
            and MIN_ROWS <= math.prod(x.shape[:-1]) < 2 ** 31
            and w.shape[1] < 2 ** 31)


# The two launches as dispatcher ops, so that what counts the operations
# of a step (``FlopCounterMode``: roofline/analysis.py, the dry run's check
# against the card) sees them.  They count the plain fp32 product's
# 2 M N K a product, not the split's three or six bf16 products of that
# size, so the counts stay the plain path's.
@torch.library.custom_op("repro_torch::head_matmul_fwd", mutates_args=())
def _fwd_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return head_fwd_kernel(x, head_split_kernel(w))


@torch.library.custom_op("repro_torch::head_matmul_bwd", mutates_args=())
def _bwd_op(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
            need_dx: bool, need_dw: bool
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    g_parts = head_split_kernel(g)
    dw = (head_dw_kernel(x, g_parts) if need_dw
          else w.new_empty((0,)))
    dx = (head_dx_kernel(g_parts, head_split_kernel(w)) if need_dx
          else w.new_empty((0,)))
    return dx, dw


@register_flop_formula(torch.ops.repro_torch.head_matmul_fwd)
def _fwd_flops(x_shape, w_shape, *args, **kwargs) -> int:
    return 2 * x_shape[0] * w_shape[0] * w_shape[1]


@register_flop_formula(torch.ops.repro_torch.head_matmul_bwd)
def _bwd_flops(x_shape, w_shape, g_shape, need_dx, need_dw, *args,
               **kwargs) -> int:
    return 2 * x_shape[0] * w_shape[0] * w_shape[1] * (int(need_dx)
                                                       + int(need_dw))


class HeadMatmul(torch.autograd.Function):
    """x (M, K) bf16 @ w (K, N) fp32 -> (M, N) fp32.  Saves x and w."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _fwd_op(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_dx, need_dw = ctx.needs_input_grad[:2]
        dx, dw = _bwd_op(x, w, g, need_dx, need_dw)
        return (dx if need_dx else None), (dw if need_dw else None)


def head_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) bf16 and w (K, N) fp32 that :func:`takes` accepts ->
    (..., N) fp32 logits, differentiable in x and w.  Where no gradient is
    asked for, the forward runs alone and keeps nothing."""
    if not takes(x, w):
        raise ValueError(
            f"head_matmul: x {tuple(x.shape)} {x.dtype} on {x.device}, w "
            f"{tuple(w.shape)} {w.dtype} strides {w.stride()}: needs bf16 x "
            f"and fp32 w on CUDA, widths multiples of 8, w's rows "
            f"contiguous and at least {MIN_ROWS} rows")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        y = HeadMatmul.apply(x2, w)
    else:
        y = _fwd_op(x2, w)
    return y.reshape(*lead, w.shape[1])
