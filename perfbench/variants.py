"""The roofline share of one variant, band or wide, of B1 or B2 in a
training cell, from the device trace and the port's record of the stacks a
captured step holds.

`perfbench.fused` divides the bound of every identity stack by the band
operations' time, which holds only where every stack takes the band
variant; a cell whose stacks take both variants, or run one layer by
layer, is read here.  The record of the last captured "train step"
(`perfbench.stacks.recorded_step`) lists, in launch order, each stack of
the forward once (its B1 call, or a "per_layer" entry where it ran layer
by layer) and each B2 call, with its variant and launches.  Operations by
(kernel, variant): the band B1 ``euler_fwd`` and the band B2 ``euler_bwd``
(`perfbench.fused`'s names); both wide kernels ``wide_conv`` and
``wide_dk`` (``csrc/fused_euler_wide.cu``: B1 launches ``wide_conv`` once
a layer, B2 ``wide_conv`` once a layer for the recompute, then ``wide_dk``
and ``wide_conv`` once a layer each in reverse).  A replay runs the
launches of the entries that share those names in the record's order, so
the window's operations under the names, in the order they started, are
that sequence once a step: each operation goes to the kernel of the entry
whose launches hold its place in the step (every wide B1 launch of the
forward comes before every wide B2 launch).  A share is the frozen bound
(`frozen.kernel_bounds`, one call a step) summed over the kernel's entries
of the variant, over their device time a step.  No reading where there is
no record (a port without one), where the record's forward entries are not
the model's identity stacks in order (a port that does not record a stack
run layer by layer) or its B2 entries not the model's stacks, where the
kernel has no entry of the variant, or where the window's operations are
not a whole number of such steps.
"""

from __future__ import annotations

from perfbench import frozen
from perfbench.fused import B1_NAMES, B2_NAMES
from perfbench.stacks import recorded_step

WIDE_NAMES = ("wide_conv", "wide_dk")
NAMES = {("B1", "band"): B1_NAMES, ("B2", "band"): B2_NAMES,
         ("B1", "wide"): WIDE_NAMES, ("B2", "wide"): WIDE_NAMES}


def variant_pct(ctx, kernel: str, variant: str):
    """B1's or B2's (``kernel``) share of its roofline, in %, over a step
    of the stacks that run it in ``variant`` ("band" or "wide")."""
    if (ctx.info["kind"] != "train" or ctx.config["family"] != "single_block"
            or not ctx.info["calls"]):
        return None
    entries = recorded_step()
    if not entries:
        return None
    stacks = [tuple(s) for s in frozen.identity_stacks(ctx.config["model"])]
    forward = [tuple(e.shape) for e in entries if e.kernel in ("B1", "per_layer")]
    names = NAMES[kernel, variant]
    sharing = [e for e in entries if NAMES.get((e.kernel, e.variant)) == names]
    if (forward != stacks or not any(e.kernel == kernel for e in sharing)
            or any(tuple(e.shape) not in stacks for e in entries if e.kernel == "B2")):
        return None
    owner = [e.kernel for e in sharing for _ in range(e.launches)]
    ops = sorted((s, e) for name, s, e in ctx.trace.device_ops if any(n in name for n in names))
    if not owner or len(ops) != len(owner) * ctx.info["calls"]:
        return None
    used = sum(e - s for i, (s, e) in enumerate(ops) if owner[i % len(owner)] == kernel)
    if used <= 0:
        return None
    bound = sum(frozen.kernel_bounds(ctx.info["batch"], *e.shape, kernel == "B2")["bound_ms"]
                for e in sharing if e.kernel == kernel)
    return 100.0 * bound / (used / 1e3 / ctx.info["calls"])
