"""Batch norm's device time a train step, in ms: the device operations whose
names hold ``fused_bn_``, the common prefix of the train-mode batch-norm
kernels (``csrc/batch_norm.cu``), over the traced window's steps.  The
forward's statistics, `torch.var_mean`'s reduction, are not among them.
No such operation (a port without the kernels): no reading."""

BN_PREFIX = "fused_bn_"


def read(ctx):
    if ctx.info["kind"] != "train" or not ctx.info["calls"]:
        return None
    used, count = ctx.trace.device_time_us(lambda op: BN_PREFIX in op)
    if not count:
        return None
    return used / 1e3 / ctx.info["calls"]
