"""accum_ms.lm: device time of the LM train step's gradient and loss
accumulation, a step, in ms: the sum of the ``accumulate`` spans' device
extents (``runtime/train.py``: the accumulators' zero fill, each
micro-batch's adds, the final divide; their CUDA event pairs), the mean
over steps traced without the profiler (``perfbench/program_trace.py``)."""
from perfbench import program_trace


def read(ctx):
    got = program_trace.read(ctx)
    if got is None or got["unit"] != "step" \
            or "accumulate" not in got["spans"]:
        return None
    return got["spans"]["accumulate"]["extent_ms"]
