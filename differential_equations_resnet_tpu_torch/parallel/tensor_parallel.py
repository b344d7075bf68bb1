"""Channel tensor parallelism of the identity stacks (``tp_mesh``).

The JAX package shards the materialized dense kernels on c_out over the
mesh's ``model`` axis and the activations on channels between layers
(`_dense_blocks`, `_tp_constrain`), and GSPMD turns the unsharded program
into a sharded one with the same numbers.  The port runs the same layers
in Megatron form.  Each rank of the ``model`` group:

- materializes the whole dense kernel stack (replicated: O(9 C^2) a layer,
  so both members of each antisymmetric (i, j)/(j, i) pair come from the
  replicated packed parameters) and keeps its c_out slice
  (`shard_out_channels`);
- convolves the full activations into its slice of the output channels
  and applies the relu (`field`);
- all-gathers the slices over the group and does the residual add on full
  channels.

The backward gives the unsharded model's gradients: the slice conv's
input gradient is partial and is summed over the group, and so is the
kernel stack's (`parallel.collectives.copy_to_group`), so every rank holds
the whole dK, db and dx.  An int8 layer takes its quantization scales from
the whole tensors, as the unsharded program does: the kernel's from the
full kernel, the cotangent's from the max over the group and, inside a
data-parallel step, the activations' and the cotangent's over the data
axis too (`ops.quantize.absmax_groups`, `_Int8FieldSlice`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from differential_equations_resnet_tpu_torch.models.blocks import ConvParams
from differential_equations_resnet_tpu_torch.ops.conv import conv2d_same, conv_relu_field
from differential_equations_resnet_tpu_torch.ops.quantize import (
    QuantizedConvParams,
    _check_int8_args,
    _dynamic_int8_conv_parts,
    _int8_linear_bwd,
    _save_residuals,
    quantize_kernel_per_tensor,
)
from differential_equations_resnet_tpu_torch.parallel.collectives import (
    copy_to_group,
    gather_channels,
)


def channel_slice(channels: int, group, axis: str = "model") -> slice:
    """This rank's block of ``channels`` output channels over ``group``."""
    size = dist.get_world_size(group)
    if channels % size:
        raise ValueError(
            f"channels ({channels}) must divide evenly over the "
            f"{size}-way tensor-parallel axis {axis!r}"
        )
    per = channels // size
    rank = dist.get_rank(group)
    return slice(rank * per, (rank + 1) * per)


def shard_out_channels(dense: ConvParams, group) -> ConvParams:
    """This rank's c_out slice of stacked dense kernels (..., C, C) and
    biases (..., C); the gradients of the whole stack are summed over the
    group."""
    sl = channel_slice(dense.kernel.shape[-1], group)
    kernel, bias = copy_to_group(dense.kernel, group), copy_to_group(dense.bias, group)
    return ConvParams(kernel[..., sl], bias[..., sl])


def field(y: torch.Tensor, p: ConvParams, group) -> torch.Tensor:
    """relu(conv(y, K) + b) on full channels from a rank's slice ``p`` of
    the layer's kernel and bias: this rank's output channels, all-gathered
    over the group."""
    return gather_channels(conv_relu_field(copy_to_group(y, group), p.kernel, p.bias), group)


def euler_step(y: torch.Tensor, p: ConvParams, h: float, group) -> torch.Tensor:
    """One Euler step ``y + h * relu(conv(y, K) + b)`` in Megatron form."""
    return y + h * field(y, p, group)


def conv(y: torch.Tensor, p: ConvParams, group) -> torch.Tensor:
    """conv(y, K) + b on full channels from a rank's slice ``p`` (the
    batch-norm stack's conv, before its norm)."""
    return gather_channels(conv2d_same(copy_to_group(y, group), p.kernel, bias=p.bias), group)


class _Int8FieldSlice(torch.autograd.Function):
    """relu(int8conv(y, K[..., sl]) + b[sl]) with the kernel quantized per
    tensor over the whole kernel; its backward in ``backward``'s mode with
    the cotangent quantized over the group's slices.  The kernel and bias
    cotangents are the whole tensors', zero outside ``sl``."""

    @staticmethod
    def forward(ctx, y, kernel, bias, lo, hi, backward, group):
        full = quantize_kernel_per_tensor(kernel, bias)
        qp = QuantizedConvParams(full.kernel_q[..., lo:hi], full.scale[..., lo:hi],
                                 full.bias[..., lo:hi])
        z, yq, s_y = _dynamic_int8_conv_parts(y, qp)
        ctx.tp_group = group
        _save_residuals(ctx, backward, y, kernel[..., lo:hi], yq, s_y, qp, z > 0)
        ctx.lo, ctx.hi, ctx.shape = lo, hi, kernel.shape
        return torch.relu(z)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        *saved, mask = ctx.saved_tensors
        g_z = torch.where(mask, g, 0.0).to(g.dtype)
        dy, dk_slice, db_slice = _int8_linear_bwd(ctx.backward, saved, g_z, ctx.kernel_dtype,
                                                  ctx.groups)
        dk = dk_slice.new_zeros(ctx.shape)
        dk[..., ctx.lo:ctx.hi] = dk_slice
        db = db_slice.new_zeros(ctx.shape[-1:])
        db[ctx.lo:ctx.hi] = db_slice
        return dy, dk, db, None, None, None, None


def int8_field(y: torch.Tensor, p: ConvParams, group, backward: str) -> torch.Tensor:
    """The int8 field on full channels from the whole layer ``p`` (the
    kernel's scale needs all of it): this rank's output channels,
    all-gathered."""
    _check_int8_args("int8 tensor-parallel field", p.kernel, p.bias, "per_tensor", backward)
    sl = channel_slice(p.kernel.shape[-1], group)
    z = _Int8FieldSlice.apply(copy_to_group(y, group), copy_to_group(p.kernel, group),
                              copy_to_group(p.bias, group), sl.start, sl.stop, backward, group)
    return gather_channels(z, group)
