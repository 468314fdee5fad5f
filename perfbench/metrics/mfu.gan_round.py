"""mfu.gan_round: model FLOPs of a round (perfbench.flops, from the DCGAN
shapes) over the mean wall time of the traced run's untraced rounds at
the H100's fp32 peak (the trainer runs its convolutions with TF32 off),
in %."""
from perfbench.flops import PEAK_FLOPS_FP32


def read(ctx):
    tr, sess = ctx["trace"], ctx["session"]
    if tr is None or sess.unit != "round" or not tr["step_s"]:
        return None
    return 100.0 * sess.model_flops_per_step() / (tr["step_s"]
                                                  * PEAK_FLOPS_FP32)
