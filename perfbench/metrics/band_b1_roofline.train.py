"""The band B1's share of its roofline, in %, over the stacks that run it
(`perfbench.variants`): where other stacks take the wide variant or run
layer by layer, `b1_roofline.train` would divide their bounds too by the
band operations' time."""

from perfbench.variants import variant_pct


def read(ctx):
    return variant_pct(ctx, "B1", "band")
