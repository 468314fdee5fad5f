"""client_wait_ms.gan: time the device waited on the host inside the
client program, a round, in ms: the ``client`` span's device extent
(``RoundExecutor.run``, its CUDA event pair, rounds traced without the
profiler) less the busy union of the device operations launched inside it
(rounds traced under the profiler), both the mean a round
(``perfbench/program_trace.py``)."""
from perfbench import program_trace


def read(ctx):
    got = program_trace.read(ctx)
    if got is None or got["unit"] != "round" or "client" not in got["spans"]:
        return None
    client = got["spans"]["client"]
    return client["extent_ms"] - client["busy_ms"]
