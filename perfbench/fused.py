"""The roofline share of the fused Euler stack's kernels, B1 (forward) and B2
(backward), from the device trace.

A kernel's work at the cell's shape is the frozen `frozen.kernel_bounds`
(the larger of its FLOPs over the fp32 peak and its bytes over HBM's
rate); its time is the device time of the operations whose names hold
one of the kernel's names, over the calls of the traced window (one B1
call a request or step, one B2 call a train step).  The band kernels are
``euler_fwd`` and ``euler_bwd`` (``csrc/fused_euler_fwd.cu``,
``csrc/fused_euler_bwd.cu``); the wide variants, which these cells'
shapes do not take, are not attributed.  No such operation: no reading.
"""

from perfbench import frozen

B1_NAMES = ("euler_fwd",)
B2_NAMES = ("euler_bwd",)


def roofline_pct(ctx, names, backward: bool):
    model = ctx.config["model"]
    if ctx.config["family"] != "single_block" or not ctx.info["calls"]:
        return None
    used, count = ctx.trace.device_time_us(lambda op: any(n in op for n in names))
    if not count or used <= 0:
        return None
    height, width, _ = model["image_shape"]
    bound = frozen.kernel_bounds(ctx.info["batch"], height, width, model["filters_per_block"][0],
                                 model["blocks_per_stage"][0], backward)
    return 100.0 * bound["bound_ms"] / (used / 1e3 / ctx.info["calls"])
