"""B1's share of its roofline, in %, at the cell's shape (`perfbench.fused`)."""

from perfbench.fused import B1_NAMES, roofline_pct


def read(ctx):
    if ctx.info["kind"] != "serve":
        return None
    return roofline_pct(ctx, B1_NAMES, backward=False)
