"""Roofline model of the port's kernels on the H100 (port of
``repro/roofline``: the analytic terms; the XLA-artifact analysis waits for
ROADMAP Queue A item 16)."""
from repro_torch.roofline.hw import H100, HwSpec  # noqa: F401
from repro_torch.roofline.analysis import (  # noqa: F401
    agg_fuse_terms, dp_clip_terms, fedavg_terms, fused_boundary_terms,
    roofline_terms)
