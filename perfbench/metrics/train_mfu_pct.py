"""The whole train step's share of the H100's fp32 peak, in %: the frozen
nominal model FLOPs a step (three times the forward's, `perfbench.frozen`)
times the traced window's steps a second, over 67 TFLOP/s."""

from perfbench import frozen


def read(ctx):
    if ctx.info["kind"] != "train" or ctx.trace.window_us <= 0:
        return None
    flops = frozen.train_flops(ctx.config["family"], ctx.config["model"], ctx.info["batch"])
    steps_per_s = ctx.info["calls"] / (ctx.trace.window_us / 1e6)
    return 100.0 * flops * steps_per_s / frozen.PEAK_FP32_FLOPS
