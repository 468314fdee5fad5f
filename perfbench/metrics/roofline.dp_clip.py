"""roofline.dp_clip: the dp_clip call's least time at its shape (the
(B, N) fp32 per-example stack and the noise read once, the sum written
once, at the HBM bandwidth) over the mean device time of a call's three
CUDA kernels (row_pass, row_scales, col_pass) in the trace, in %."""
from perfbench.flops import dp_clip_terms

KERNELS = ("row_pass", "row_scales", "col_pass")


def read(ctx):
    tr = ctx["trace"]
    shape = ctx["session"].dp_clip_shape()
    if tr is None or shape is None:
        return None
    names = [(n, d) for n, _, d in tr["device"]
             if any(k in n for k in KERNELS)]
    calls = sum(1 for n, _ in names if "row_pass" in n)
    if not calls:
        return None
    mean_s = sum(d for _, d in names) / calls / 1e6
    return 100.0 * dp_clip_terms(*shape)["t_bound_s"] / mean_s
