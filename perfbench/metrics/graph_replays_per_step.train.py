"""Captured CUDA graphs replayed a train step: the ``deqres.replay`` ranges
inside the traced window over its steps (none where the step runs
eagerly, as on the CPU)."""


def read(ctx):
    if ctx.info["kind"] != "train" or not ctx.info["calls"]:
        return None
    windows = ctx.trace.windows
    replays = sum(1 for name, s, e in ctx.trace.host_ops if name == "deqres.replay"
                  and any(ws <= s and e <= we for ws, we in windows))
    return replays / ctx.info["calls"] if replays else None
