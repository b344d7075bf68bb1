"""Device-busy time a request, in ms: the union of the device operations'
intervals inside the traced requests' host ranges, over the requests."""

from perfbench.trace import covered


def read(ctx):
    requests = ctx.trace.spans.get("request", [])
    if ctx.info["kind"] != "serve" or not requests:
        return None
    busy = ctx.trace.busy_intervals
    return sum(covered(busy, s, e) for s, e in requests) / 1e3 / len(requests)
