"""The roofline share of the fused Euler stack's kernels, B1 (forward) and B2
(backward), from the device trace.

A kernel's work in a step is the frozen `frozen.kernel_bounds` (the larger
of its FLOPs over the fp32 peak and its bytes over HBM's rate) summed over
the model's identity stacks, each at its stage's shape (one B1 and one B2
call a stack); its time is the device time of the operations whose names
hold one of the kernel's names, over the requests or steps of the traced
window.  The band kernels are
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
    return 100.0 * bound_ms(model, ctx.info["batch"], backward) / (used / 1e3 / ctx.info["calls"])


def bound_ms(model: dict, batch: int, backward: bool) -> float:
    """The least time B1 (or B2) could take over a step of ``model``: the
    sum of `frozen.kernel_bounds` over its identity stacks."""
    return sum(frozen.kernel_bounds(batch, height, width, channels, layers, backward)["bound_ms"]
               for height, width, channels, layers in frozen.identity_stacks(model))
