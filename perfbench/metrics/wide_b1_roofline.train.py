"""The wide B1's share of its roofline, in %, over the stacks that run it
(`perfbench.variants`)."""

from perfbench.variants import variant_pct


def read(ctx):
    return variant_pct(ctx, "B1", "wide")
