"""head_kernel_share.lm: the share of a step's LM-head products that took
the split-bf16 tensor-core kernels, in %: 100 x ``head_kernel`` /
(``head_kernel`` + ``head_plain``), the counters of ``models/layers.py``'s
``_f32_matmul`` (one a call of the step's forward passes), read from the
one counting step that ``expert_fill.lm`` runs after the steps of
``perfbench/program_trace.py`` (whichever of the readers reads first runs
it).  A program without the counters gives None."""
from perfbench import common, program_trace


def read(ctx):
    if program_trace.read(ctx) is None or ctx["session"].unit != "step":
        return None
    sess = ctx["session"]
    if not hasattr(sess, "expert_counters"):
        fill = common.load_module(common.BENCH_DIR / "metrics"
                                  / "expert_fill.lm.py")
        sess.expert_counters = fill.measure(sess)
    got = sess.expert_counters or {}
    calls = got.get("head_kernel", 0) + got.get("head_plain", 0)
    if not calls:
        return None
    return 100.0 * got.get("head_kernel", 0) / calls
