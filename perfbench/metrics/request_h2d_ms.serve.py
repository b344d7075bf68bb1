"""A request's conversion and copy to the card, in ms: the median duration
of `predict`'s ``deqres.predict.h2d`` ranges inside the traced window."""

import statistics


def read(ctx):
    if ctx.info["kind"] != "serve":
        return None
    windows = ctx.trace.windows
    copies = [e - s for name, s, e in ctx.trace.host_ops if name == "deqres.predict.h2d"
              and any(ws <= s and e <= we for ws, we in windows)]
    return statistics.median(copies) / 1e3 if copies else None
