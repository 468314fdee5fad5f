"""Roofline terms of the port's kernels, counted from their shapes.  Port of
the analytic part of ``repro/roofline/analysis.py``.

    compute_term = operations / the card's float32 peak
    memory_term  = bytes / the card's HBM bandwidth
    bound        = the larger of the two

The kernels compute in float32 on the CUDA cores, so the compute term uses
the float32 peak (the reference divides by the TPU's bf16 peak).  Bytes
count each input read once and each output written once, as the port's
kernels move them: boundary_fuse reads x once (its rows held on chip), the
agg_fuse reduce reads each client's wire where it lies, fedavg reads each
client's parameters in place.  XLA's ``cost_analysis`` has no counterpart
here; the counts below take its place for every kernel.  The reference's
``analyze_compiled`` and ``collective_bytes_from_hlo`` read XLA artifacts
and wait for ROADMAP Queue A item 16.
"""
from __future__ import annotations

from typing import Dict, Union

from repro_torch.roofline.hw import H100, HwSpec

Terms = Dict[str, Union[float, str]]

# operations a boundary element costs: qdq (int8: |x|, max, divide, round,
# two clamps, multiply; fp16: two conversions), the square-and-add of the
# norm, the scale and the noise fma
BOUNDARY_OPS = {"none": 5, "fp16": 7, "int8": 12}

_WIRE_BYTES = {"none": 4.0, "fp16": 2.0, "int8": 1.0}


def roofline_terms(flops: float, nbytes: float, hw: HwSpec = H100) -> Terms:
    """The compute and memory terms of ``flops`` float32 operations over
    ``nbytes`` of HBM traffic, and the bound: the larger, with which of
    the two it is (``"bytes"`` or ``"operations"``)."""
    compute = flops / hw.peak_flops_fp32
    memory = nbytes / hw.hbm_bw
    return {"flops": float(flops), "bytes_accessed": float(nbytes),
            "compute_term_s": compute, "memory_term_s": memory,
            "arithmetic_intensity": flops / nbytes if nbytes else 0.0,
            "bound_s": max(compute, memory),
            "bound_by": "bytes" if memory >= compute else "operations"}


def fedavg_terms(num_clients: int, n: int, *, hw: HwSpec = H100) -> Terms:
    """The fedavg reduce of ``num_clients`` fp32 rows of ``n`` elements:
    each row and the (C,) weights read once, the mean written once;
    one multiply-add an element of a row."""
    c, nn = float(num_clients), float(n)
    return {"num_clients": c, "n": nn,
            **roofline_terms(2.0 * c * nn, 4.0 * (c * nn + c + nn), hw)}


def dp_clip_terms(batch: int, n: int, *, hw: HwSpec = H100) -> Terms:
    """The DP-SGD release over a (B, N) fp32 per-example stack: the stack
    and the (N,) noise read once, the (N,) privatized sum written once;
    a square-and-add and a scale-and-add an element, one noise fma a
    column."""
    b, nn = float(batch), float(n)
    return {"batch": b, "n": nn,
            **roofline_terms(4.0 * b * nn + 2.0 * nn,
                             4.0 * (b * nn + 2.0 * nn), hw)}


def fused_boundary_terms(batch: int, features: int, *, codec: str = "int8",
                         hw: HwSpec = H100) -> Terms:
    """The fused boundary kernel (codec qdq + per-example clip + noise)
    over one flattened ``(batch, features)`` crossing: x and the noise
    read once, the output written once, all fp32 (``3 * 4 * B * N``
    bytes).  ``unfused_bytes_accessed`` is what three separate traversals
    (codec, clip norm, scale and noise), each a read and a write, move."""
    n = float(batch) * float(features)
    return {"codec": codec, "batch": float(batch),
            "features": float(features),
            **roofline_terms(BOUNDARY_OPS[codec] * n, 3.0 * 4.0 * n, hw),
            "unfused_bytes_accessed": 3.0 * 2.0 * 4.0 * n}


def agg_fuse_terms(num_clients: int, n: int, *, codec: str = "int8",
                   hw: HwSpec = H100) -> Terms:
    """The fused dequant-reduce (``kernels/agg_fuse``): ``num_clients``
    wires of ``n`` elements read once each at their wire width (1 B int8,
    2 B fp16, 4 B fp32) where they lie, the (C, 2) weight and scale
    coefficients read once, the fp32 mean written once:
    ``wire_b * C * N + 8 * C + 4 * N`` bytes; one fma an element of a
    wire.  ``unfused_bytes_accessed`` adds what decode-then-reduce moves
    besides: each client's fp32 decode written and read back."""
    wire_b = _WIRE_BYTES.get(codec, 4.0)
    c, nn = float(num_clients), float(n)
    return {"codec": codec, "num_clients": c, "n": nn,
            "wire_bytes_per_elem": wire_b,
            **roofline_terms(2.0 * c * nn, wire_b * c * nn + 8.0 * c
                             + 4.0 * nn, hw),
            "unfused_bytes_accessed": wire_b * c * nn + 8.0 * c * nn
                                      + 4.0 * nn}
