"""train_tok_s: tokens of the training steps completed in the window over
the window's wall time (host clock, ending after a device synchronise)."""


def read(ctx):
    if not ctx["tokens"]:
        return None
    return ctx["tokens"] / ctx["window_s"]
