"""Roofline model on the H100 (port of ``repro/roofline``): the port's
kernels' terms from their shapes, a whole step's from the dry run's counts
(``analyze_step``), and the probe differencing that carries them to full
depth (``probes.py``)."""
from repro_torch.roofline.hw import H100, HwSpec  # noqa: F401
from repro_torch.roofline.analysis import (  # noqa: F401
    RooflineReport, StepCounts, StepTrace, agg_fuse_terms, analyze_step,
    collective_bytes, dp_clip_terms, fedavg_terms, fused_boundary_terms,
    kernel_terms, rank_bytes, roofline_terms, shard_factor)
