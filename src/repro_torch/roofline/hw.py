"""Target-hardware constants: one NVIDIA H100 (SXM, 80 GB).  Port of
``repro/roofline/hw.py``, whose TPU constants the port does not use.

The published dense peaks of NVIDIA's data sheet, at the card's full power
limit of 700 W (a card set below it runs slower under load): 989 TFLOP/s
in bf16 on the tensor cores, 67 TFLOP/s in float32 outside them, 3.35 TB/s
of HBM3, 80 GB of it, and 50 MB of L2.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class HwSpec:
    name: str
    peak_flops_bf16: float     # FLOP/s, tensor cores
    peak_flops_fp32: float     # FLOP/s, CUDA cores
    hbm_bw: float              # bytes/s
    hbm_bytes: float
    l2_bytes: float


H100 = HwSpec(
    name="h100-sxm",
    peak_flops_bf16=989e12,
    peak_flops_fp32=67e12,
    hbm_bw=3.35e12,
    hbm_bytes=80e9,
    l2_bytes=50 * 1024 ** 2,
)
