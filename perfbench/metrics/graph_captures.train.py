"""CUDA graphs captured inside the traced training window: its
``deqres.capture`` ranges, where it replays graphs at all (above 0, a graph
was captured again mid-training)."""


def read(ctx):
    if ctx.info["kind"] != "train":
        return None
    windows = ctx.trace.windows
    names = [name for name, s, e in ctx.trace.host_ops
             if name in ("deqres.replay", "deqres.capture")
             and any(ws <= s and e <= we for ws, we in windows)]
    return float(names.count("deqres.capture")) if "deqres.replay" in names else None
