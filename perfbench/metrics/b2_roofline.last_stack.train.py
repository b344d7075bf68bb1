"""B2's share of its roofline, in %, in the model's last identity stack
(`perfbench.stacks`)."""

from perfbench.stacks import last_stack_pct


def read(ctx):
    return last_stack_pct(ctx, backward=True)
