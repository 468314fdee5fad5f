"""mla_ms.lm: device time of MLA attention a step, in ms: the sum of the
``mla`` spans' device extents (``models/mla.py``: each MLA attention call
of the step's forward passes, one a layer and a micro-batch; remat's
recompute in the backward opens none), the mean over steps traced without
the profiler (``perfbench/program_trace.py``)."""
from perfbench import program_trace


def read(ctx):
    got = program_trace.read(ctx)
    if got is None or got["unit"] != "step" or "mla" not in got["spans"]:
        return None
    return got["spans"]["mla"]["extent_ms"]
