"""Plain PyTorch references of the split-bf16 head products
(``csrc/head_gemm.cu``).

:func:`split3` is the split pass: an fp32 value v is hi + mid + lo with
hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid), each rounded to
nearest even, and each difference exact in fp32.  The three parts hold v's
24 significant bits, 8 each, so the sum is v itself for every finite v
with ``EXACT_MIN`` <= |v| < ``EXACT_MAX``.  Below 2^-110 lo's lowest bit
(v's 2^-23 ulp) falls under bf16's least subnormal, 2^-133, and the parts
lose at most that much; from ``EXACT_MAX`` up hi rounds to infinity.

:data:`TERMS` lists the (A part, B part) pairs each product sums, in the
kernel's order (smallest first); :func:`split_product` is their sum in
float64, the value the kernel rounds.  :func:`oracle` and :func:`row_err`
are the yardstick the kernels' precision is held to, beside the plain
fp32 product's.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

EXACT_MIN = 2.0 ** -110
EXACT_MAX = (2.0 - 2.0 ** -8) * 2.0 ** 127     # rounds to bf16 infinity

# (A part, B part), 0 hi, 1 mid, 2 lo: x (one part) times w's or G's parts;
# G's parts times w's, the six pairs whose products reach fp32's 24 bits
# (mid.lo, lo.mid and lo.lo, each under 2^-24 of a product, dropped)
TERMS = {"fwd": ((0, 2), (0, 1), (0, 0)),
         "dw": ((0, 2), (0, 1), (0, 0)),
         "dx": ((1, 1), (2, 0), (0, 2), (1, 0), (0, 1), (0, 0))}


def split3(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """fp32 ``t`` -> its bf16 parts (hi, mid, lo)."""
    t = t.to(torch.float32)
    hi = t.to(torch.bfloat16)
    r1 = t - hi.to(torch.float32)
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.to(torch.float32)).to(torch.bfloat16)
    return hi, mid, lo


def split_product(a_parts: Sequence[torch.Tensor],
                  b_parts: Sequence[torch.Tensor],
                  terms: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """sum over ``terms`` of a_parts[i] @ b_parts[j], in float64."""
    f64 = torch.float64
    return sum(a_parts[i].to(f64) @ b_parts[j].to(f64) for i, j in terms)


def oracle(a: torch.Tensor, b: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A.B and |A|.|B| in float64."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    return a @ b, a.abs() @ b.abs()


def row_err(y: torch.Tensor, oracle: torch.Tensor,
            scale: torch.Tensor) -> float:
    """The largest error of an output row of ``y`` against the float64
    product ``oracle`` = A.B, over that row's largest |A|.|B| (``scale``,
    float64)."""
    d = (y.to(torch.float64) - oracle).abs().amax(-1)
    return float((d / scale.amax(-1).clamp_min(1e-300)).max())
