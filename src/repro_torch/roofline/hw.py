"""Target-hardware constants: one NVIDIA H100 (SXM, 80 GB).  Port of
``repro/roofline/hw.py``, whose TPU constants the port does not use.

The published dense peaks of NVIDIA's data sheet, at the card's full power
limit of 700 W (a card set below it runs slower under load): 989 TFLOP/s
in bf16 on the tensor cores, 67 TFLOP/s in float32 outside them, 3.35 TB/s
of HBM3, 80 GB of it, and 50 MB of L2.

NVLink 4 gives a GPU 900 GB/s over 18 links: 50 GB/s a link, counting
both directions.  The dry run's collective term divides a chip's
collective bytes by ONE link's 50 GB/s, the reference's one-link
convention (it divides by one ICI link); a GPU behind an NVSwitch drives
all 18 links at once, so the term is a bound 18 times looser than the
aggregate rate would give.
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
    link_bw_per_link: float = 0.0   # bytes/s, one link, both directions


H100 = HwSpec(
    name="h100-sxm",
    peak_flops_bf16=989e12,
    peak_flops_fp32=67e12,
    hbm_bw=3.35e12,
    hbm_bytes=80e9,
    l2_bytes=50 * 1024 ** 2,
    link_bw_per_link=900e9 / 18,
)
