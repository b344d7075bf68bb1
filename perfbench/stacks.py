"""The roofline share of the last identity stack's B1 (or B2) in a
training cell, from the device trace and the port's record of the fused
stacks a captured step holds.

The port records each B1 and B2 call of a captured graph, in launch order,
with its stack's (H, W, C, L), variant and launches
(``differential_equations_resnet_tpu_torch.utils.tracing.STACKS``; the
graph of the last captured "train step").  A replay of that graph runs the
band B1's launches stack by stack forward, then B2's in reverse.  The
window's band operations (`perfbench.fused`'s names), in the order they
started, are that sequence once a step: each operation goes to the stack
whose launches hold its place in the step.  A stack's share is its frozen
bound (`frozen.kernel_bounds`, one call a step) over its device time a
step.  No record (a port without one), a record that is not the model's
stacks, a stack that does not run the band variant, or a window whose band
operations are not a whole number of such steps: no reading.
"""

from __future__ import annotations

from perfbench import frozen
from perfbench.fused import B1_NAMES, B2_NAMES


def recorded_step():
    """The port's record of the last captured train step: a list of entries
    with ``kernel``, ``shape``, ``variant`` and ``launches``, or None."""
    from differential_equations_resnet_tpu_torch.utils import tracing

    record = getattr(tracing, "STACKS", None)
    return record.graph("train step") if record is not None else None


def last_stack_pct(ctx, backward: bool):
    """B1's (or B2's) share of its roofline, in %, in the model's last
    identity stack."""
    if (ctx.info["kind"] != "train" or ctx.config["family"] != "single_block"
            or not ctx.info["calls"]):
        return None
    entries = recorded_step()
    if not entries:
        return None
    stacks = [tuple(s) for s in frozen.identity_stacks(ctx.config["model"])]
    kernel = "B2" if backward else "B1"
    calls = [e for e in entries if e.kernel == kernel]
    if not stacks or [tuple(e.shape) for e in calls] != (stacks[::-1] if backward else stacks):
        return None
    at = 0 if backward else len(stacks) - 1  # B2 runs the stacks in reverse
    if calls[at].variant != "band":
        return None
    first = sum(e.launches for e in calls[:at] if e.variant == "band")
    last = first + calls[at].launches
    period = sum(e.launches for e in calls if e.variant == "band")
    names = B2_NAMES if backward else B1_NAMES
    ops = sorted((s, e) for name, s, e in ctx.trace.device_ops if any(n in name for n in names))
    if not period or len(ops) != period * ctx.info["calls"]:
        return None
    used = sum(e - s for i, (s, e) in enumerate(ops) if first <= i % period < last)
    if used <= 0:
        return None
    bound = frozen.kernel_bounds(ctx.info["batch"], *stacks[-1], backward)["bound_ms"]
    return 100.0 * bound / (used / 1e3 / ctx.info["calls"])
