"""The device's idle share of the traced training window, in %: 1 - the union
of the device operations' intervals over the window's host range (whole
epochs of `Training.train`, each ending in a synchronize)."""


def read(ctx):
    if ctx.info["kind"] != "train" or ctx.trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us / ctx.trace.window_us)
