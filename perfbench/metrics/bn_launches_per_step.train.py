"""Batch norm's kernel launches a train step: the device operations whose
names hold ``fused_bn_``, the common prefix of the train-mode batch-norm
kernels (``csrc/batch_norm.cu``), over the traced window's steps (53 layers
x 4 launches in ResNet-50).  No such operation (a port without the
kernels): no reading."""

BN_PREFIX = "fused_bn_"


def read(ctx):
    if ctx.info["kind"] != "train" or not ctx.info["calls"]:
        return None
    _, count = ctx.trace.device_time_us(lambda op: BN_PREFIX in op)
    if not count:
        return None
    return count / ctx.info["calls"]
