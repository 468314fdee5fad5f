"""optim_ms.lm: device time of the optimizer update (CUDA events around
each ``Optimizer.update`` call of the train step), the mean a step over
the traced run's untraced steps, in ms."""


def read(ctx):
    tr, ms = ctx["trace"], ctx["spans_ms"].get("optim")
    if tr is None or not ms or ctx["session"].unit != "step":
        return None
    return sum(ms) / tr["timed_steps"]
