"""The streaming feed's wait a train step, in ms: the summed ``deqres.feed.wait``
ranges inside the traced window (the dispatch loop blocked on the producer
thread's queue) over the window's steps."""


def read(ctx):
    if ctx.info["kind"] != "train" or not ctx.info["calls"]:
        return None
    windows = ctx.trace.windows
    waits = [e - s for name, s, e in ctx.trace.host_ops if name == "deqres.feed.wait"
             and any(ws <= s and e <= we for ws, we in windows)]
    return sum(waits) / 1e3 / ctx.info["calls"] if waits else None
