"""host_syncs.gan: host-device synchronisations a round, all the
program's spans together (each charged to the innermost span open when
PyTorch's sync debug mode reported it: ``item``, ``tolist``, ``nonzero``,
blocking copies), the mean over rounds traced without the profiler
(``perfbench/program_trace.py``).  Each one drains the device's queue."""
from perfbench import program_trace


def read(ctx):
    got = program_trace.read(ctx)
    if got is None or got["unit"] != "round" or not got["syncs_by_step"]:
        return None
    return sum(got["syncs_by_step"]) / len(got["syncs_by_step"])
