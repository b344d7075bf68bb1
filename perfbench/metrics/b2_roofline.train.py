"""B2's share of its roofline, in %, at the cell's shape (`perfbench.fused`)."""

from perfbench.fused import B2_NAMES, roofline_pct


def read(ctx):
    if ctx.info["kind"] != "train":
        return None
    return roofline_pct(ctx, B2_NAMES, backward=True)
