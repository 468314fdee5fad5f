"""attn_kernel_share.lm: the share of a step's attention calls that took
the training flash kernels, in %: 100 x ``attn_kernel`` / (``attn_kernel``
+ ``attn_plain``), the counters of ``models/layers.py``'s ``attention``
(one a call of the step's forward passes), read from the one counting
step that ``expert_fill.lm`` runs after the steps of
``perfbench/program_trace.py`` (whichever of the two reads first runs it).
A program without the counters gives None."""
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
    calls = got.get("attn_kernel", 0) + got.get("attn_plain", 0)
    if not calls:
        return None
    return 100.0 * got.get("attn_kernel", 0) / calls
