"""g_update_ms.gan: device extent of the server's G update (the
``g_update`` span, ``FSLGANTrainer._g_updates``: its CUDA event pair), the
mean a round over rounds traced without the profiler, in ms
(``perfbench/program_trace.py``)."""
from perfbench import program_trace


def read(ctx):
    got = program_trace.read(ctx)
    if got is None or got["unit"] != "round" \
            or "g_update" not in got["spans"]:
        return None
    return got["spans"]["g_update"]["extent_ms"]
