"""expert_fill.lm: the token-slots that the experts held on this card
keep, over the capacity rows they compute, in a step, in %: the
``moe_kept`` and ``moe_capacity`` counters of ``models/moe.py`` (summed
over the MoE layers and micro-batches of the step's forward passes),
read from one more step under a tracer of this reader's own, after the
steps of ``perfbench/program_trace.py``.  A program without the counters
gives None and runs no step."""
from perfbench import program_trace


def read(ctx):
    if program_trace.read(ctx) is None or ctx["session"].unit != "step":
        return None
    sess = ctx["session"]
    if not hasattr(sess, "expert_counters"):
        sess.expert_counters = measure(sess)
    got = sess.expert_counters
    if not got or not got.get("moe_capacity"):
        return None
    return 100.0 * got["moe_kept"] / got["moe_capacity"]


def measure(sess):
    try:
        from repro_torch.obs.trace import Tracer, count, tracing  # noqa: F401
    except ImportError:          # a program that keeps no counters
        return None
    tracer = Tracer("counters")
    with tracing(tracer):
        sess.step()
    return next(iter(tracer.counters.values()), None)
