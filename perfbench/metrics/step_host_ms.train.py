"""The host's own time in one train step, in ms: the median, over the
port's ``deqres.step`` ranges inside the traced window, of a range's length
less the time in it that the host spent blocked on a full CUDA launch queue
(CUPTI's ``Command Buffer Full`` ranges).  What remains is the gather, cast
and augmentation or the copy to the card, the launches, the row copy, and
the profiler's own cost; the wait for the streaming feed is not inside a
step."""

import statistics

from perfbench.trace import covered, union

WAITS = ("Command Buffer Full",)


def read(ctx):
    if ctx.info["kind"] != "train":
        return None
    windows, ops = ctx.trace.windows, ctx.trace.host_ops
    steps = [(s, e) for name, s, e in ops if name == "deqres.step"
             and any(ws <= s and e <= we for ws, we in windows)]
    if not steps:
        return None
    waits = union([(s, e) for name, s, e in ops if name in WAITS])
    return statistics.median((e - s) - covered(waits, s, e) for s, e in steps) / 1e3
