"""Device operations a train step: those that start inside the traced window,
over its steps."""


def read(ctx):
    if ctx.info["kind"] != "train" or not ctx.info["calls"]:
        return None
    return ctx.trace.ops_within_window() / ctx.info["calls"]
