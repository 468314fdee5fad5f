"""client_ms.gan: device time of the client program (CUDA events around
each ``RoundExecutor.run`` call), the mean a round over the traced run's
untraced rounds (the profiler's slice slows the host), in ms."""


def read(ctx):
    tr, ms = ctx["trace"], ctx["spans_ms"].get("client")
    if tr is None or not ms or ctx["session"].unit != "round":
        return None
    return sum(ms) / tr["timed_steps"]
