"""idle_share.gan: the share of a round's wall time in which no operation
ran on the device, in %: 1 - (union of device intervals of the traced
rounds, a round) / (mean wall time of the same run's untraced rounds).
The profiler slows the host's launches, not the device's kernels, so the
traced rounds give the device's time and the untraced ones the round's."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or ctx["session"].unit != "round" or not tr["step_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["slice_steps"] / tr["step_s"])
