"""mfu.lm_train: model FLOPs of a training step (perfbench.flops: 6 x
active matmul parameters x tokens plus causal attention) over the mean
wall time of the traced run's untraced steps at the H100's bf16 peak (the
configuration's compute dtype), in %."""
from perfbench.flops import PEAK_FLOPS_BF16


def read(ctx):
    tr, sess = ctx["trace"], ctx["session"]
    if tr is None or sess.unit != "step" or not tr["step_s"]:
        return None
    return 100.0 * sess.model_flops_per_step() / (tr["step_s"]
                                                  * PEAK_FLOPS_BF16)
