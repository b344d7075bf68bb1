"""Device-busy time a train step, in ms: the union of the device operations'
intervals inside the traced window over its steps."""


def read(ctx):
    if ctx.info["kind"] != "train" or not ctx.info["calls"]:
        return None
    return ctx.trace.busy_us / 1e3 / ctx.info["calls"]
