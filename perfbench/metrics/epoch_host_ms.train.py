"""The host's own work at an epoch's edges, in ms an epoch: the summed
``deqres.epoch.begin`` (before the first step) and ``deqres.epoch.log``
(the rows' copy back, the CSV and summary rows) ranges inside the traced
window, less the time in them that the host spent waiting for the device
(a full launch queue, the copy back and synchronizes, which wait for the
queued steps), over the window's ``deqres.epoch.log`` ranges: a
device-resident epoch opens two ``deqres.epoch.begin``, so they do not
count epochs."""

from perfbench.trace import covered, union

WAITS = ("Command Buffer Full", "cudaMemcpyAsync", "cudaMemcpy", "cudaStreamSynchronize",
         "cudaDeviceSynchronize")


def read(ctx):
    if ctx.info["kind"] != "train":
        return None
    windows, ops = ctx.trace.windows, ctx.trace.host_ops
    inside = [(name, s, e) for name, s, e in ops
              if name in ("deqres.epoch.begin", "deqres.epoch.log")
              and any(ws <= s and e <= we for ws, we in windows)]
    epochs = sum(1 for name, _, _ in inside if name == "deqres.epoch.log")
    if not epochs:
        return None
    waits = union([(s, e) for name, s, e in ops if name in WAITS])
    return sum((e - s) - covered(waits, s, e) for _, s, e in inside) / 1e3 / epochs
