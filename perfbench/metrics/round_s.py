"""round_s: the window's wall time over the FSL-GAN rounds completed in it
(host clock; the window ends after a round and a device synchronise)."""


def read(ctx):
    if ctx["session"].unit != "round" or not ctx["steps"]:
        return None
    return ctx["window_s"] / ctx["steps"]
