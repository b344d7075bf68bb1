"""The host's part of a request, in ms: the median over the traced requests
of the request's host range (``predict``'s call) less the device-busy time
inside it."""

import statistics

from perfbench.trace import covered


def read(ctx):
    requests = ctx.trace.spans.get("request", [])
    if ctx.info["kind"] != "serve" or not requests:
        return None
    busy = ctx.trace.busy_intervals
    return statistics.median((e - s) - covered(busy, s, e) for s, e in requests) / 1e3
