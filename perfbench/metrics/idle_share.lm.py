"""idle_share.lm: the share of a training step's wall time in which no
operation ran on the device, in %: 1 - (union of device intervals of the
traced steps, a step) / (mean wall time of the same run's untraced
steps).  The profiler slows the host's launches, not the device's
kernels, so the traced steps give the device's time and the untraced ones
the step's."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or ctx["session"].unit != "step" or not tr["step_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["slice_steps"] / tr["step_s"])
