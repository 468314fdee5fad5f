"""moe_ms.lm: device time of the MoE layers a step, in ms: the sum of the
``moe`` spans' device extents (``models/moe.py``: each MoE layer call of
the step's forward passes, routed and shared experts, one a layer and a
micro-batch; remat's recompute in the backward opens none), the mean over
steps traced without the profiler (``perfbench/program_trace.py``)."""
from perfbench import program_trace


def read(ctx):
    got = program_trace.read(ctx)
    if got is None or got["unit"] != "step" or "moe" not in got["spans"]:
        return None
    return got["spans"]["moe"]["extent_ms"]
