"""Building blocks shared by the model families, in PyTorch.

Port of `differential_equations_resnet_tpu/models/blocks.py`.  Parameters are
NamedTuples of tensors in the JAX package's layouts (HWIO conv kernels,
(d_in, d_out) dense kernels).  Initializers follow TF-1.12 Keras: `he_normal`
is a truncated normal with stddev sqrt(2/fan_in), biases start at zero.
Batch norm has Keras's semantics (epsilon 1e-3, momentum 0.99, the running
variance updated with the biased batch variance), written out as the JAX
package writes it rather than through `F.batch_norm`, which updates with the
unbiased variance and the opposite momentum.  `l2_kernel_penalty` is the
training objective's Keras-style L2 term.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from differential_equations_resnet_tpu_torch.parallel.collectives import all_reduce_sum, data_group
from differential_equations_resnet_tpu_torch.ops.antisymmetric import (
    Antisym3x3DenseParams,
    Antisym3x3Params,
    AntisymKxKParams,
    he_truncated_normal,
)
from differential_equations_resnet_tpu_torch.ops.kernels.batch_norm import (
    epilogue_of,
    fused_batch_norm,
)


class ConvParams(NamedTuple):
    kernel: torch.Tensor                  # (kh, kw, c_in, c_out) HWIO
    bias: Optional[torch.Tensor] = None


class DenseParams(NamedTuple):
    kernel: torch.Tensor                  # (d_in, d_out)
    bias: torch.Tensor


class BatchNormParams(NamedTuple):
    scale: torch.Tensor                   # gamma, (C,)
    offset: torch.Tensor                  # beta, (C,)


class BatchNormState(NamedTuple):
    mean: torch.Tensor                    # running mean, (C,)
    var: torch.Tensor                     # running variance, (C,)


BN_EPSILON = 1e-3     # Keras BatchNormalization default (TF 1.12)
BN_MOMENTUM = 0.99


def init_conv(
    generator: torch.Generator,
    kernel_size: Tuple[int, int],
    c_in: int,
    c_out: int,
    use_bias: bool = True,
    dtype: torch.dtype = torch.float32,
) -> ConvParams:
    fan_in = kernel_size[0] * kernel_size[1] * c_in
    kernel = he_truncated_normal(
        generator, (kernel_size[0], kernel_size[1], c_in, c_out), fan_in, dtype
    )
    bias = torch.zeros((c_out,), dtype=dtype) if use_bias else None
    return ConvParams(kernel=kernel, bias=bias)


def init_dense(
    generator: torch.Generator, d_in: int, d_out: int, dtype: torch.dtype = torch.float32
) -> DenseParams:
    kernel = he_truncated_normal(generator, (d_in, d_out), d_in, dtype)
    return DenseParams(kernel=kernel, bias=torch.zeros((d_out,), dtype=dtype))


def init_batch_norm(channels: int, dtype: torch.dtype = torch.float32):
    """(BatchNormParams, BatchNormState): scale 1, offset 0, running mean 0,
    running variance 1."""
    params = BatchNormParams(scale=torch.ones(channels, dtype=dtype),
                             offset=torch.zeros(channels, dtype=dtype))
    state = BatchNormState(mean=torch.zeros(channels, dtype=dtype),
                           var=torch.ones(channels, dtype=dtype))
    return params, state


def batch_norm(
    x: torch.Tensor,
    params: BatchNormParams,
    state: BatchNormState,
    train: bool,
    epilogue: str = "none",
    residual: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, BatchNormState]:
    """Channel-axis (last axis) batch norm of an NHWC tensor:
    ``y = (x - mean) * rsqrt(var + 1e-3) * scale + offset``, then the op
    that follows it in the model, ``epilogue``: "none" (y), "relu"
    (``torch.relu(y)``) or "add_relu" (``torch.relu(y + residual)``).
    With ``train``, mean and biased variance over every other axis,
    through which the gradient flows, and the new running statistics
    ``0.99 * old + 0.01 * batch`` (detached); else the running statistics,
    unchanged.  Returns (out, new_state); the caller writes new_state into
    its buffers.

    Train mode on a CUDA fp32 tensor outside a data group of more than one
    rank runs the hand-written kernels behind one autograd Function
    (`ops.kernels.batch_norm.fused_batch_norm`): the composite's forward
    and the epilogue bit for bit in one apply pass, and a closed-form
    backward with fp64 sums.  Every other call (the CPU, another dtype by
    the dtype test here, more than one rank, eval mode) takes
    `composite_batch_norm` and then the epilogue's torch ops, so the
    function is the same on every route."""
    if _kernel_route(x, train):
        out, stats = fused_batch_norm(x.contiguous(), params.scale.to(x.dtype),
                                      params.offset.to(x.dtype), state.mean, state.var,
                                      BN_EPSILON, BN_MOMENTUM, epilogue, residual)
        return out, BatchNormState(mean=stats[2], var=stats[3])
    y, new_state = composite_batch_norm(x, params, state, train)
    return epilogue_of(y, epilogue, residual), new_state


def _kernel_route(x: torch.Tensor, train: bool) -> bool:
    """Whether `batch_norm` sends ``x`` to the kernels: train mode on a CUDA
    fp32 tensor outside a data group of more than one rank."""
    group = data_group()
    return (train and x.is_cuda and x.dtype == torch.float32
            and (group is None or dist.get_world_size(group) == 1))


def composite_batch_norm(
    x: torch.Tensor,
    params: BatchNormParams,
    state: BatchNormState,
    train: bool,
) -> Tuple[torch.Tensor, BatchNormState]:
    """`batch_norm` as a composite of torch ops, autograd giving its
    backward.

    Inside `parallel.collectives.data_parallel` over a group of more than
    one rank, train mode takes the moments of the whole batch, every rank's
    rows, as the JAX package's step sharded over ``data`` does: the sums
    are all-reduced with their gradient (`_global_moments`), so the running
    statistics end the same on every rank."""
    group = data_group()
    if train and group is not None and dist.get_world_size(group) > 1:
        mean, var = _global_moments(x, group)
        with torch.no_grad():
            new_state = BatchNormState(
                mean=BN_MOMENTUM * state.mean + (1.0 - BN_MOMENTUM) * mean,
                var=BN_MOMENTUM * state.var + (1.0 - BN_MOMENTUM) * var,
            )
    elif train:
        var, mean = torch.var_mean(x, dim=tuple(range(x.dim() - 1)), correction=0)
        with torch.no_grad():
            new_state = BatchNormState(
                mean=BN_MOMENTUM * state.mean + (1.0 - BN_MOMENTUM) * mean,
                var=BN_MOMENTUM * state.var + (1.0 - BN_MOMENTUM) * var,
            )
    else:
        mean, var = state.mean, state.var
        new_state = state
    inv = torch.rsqrt(var.to(x.dtype) + BN_EPSILON)
    y = (x - mean.to(x.dtype)) * inv * params.scale.to(x.dtype)
    return y + params.offset.to(x.dtype), new_state


def _global_moments(x: torch.Tensor, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, biased variance) per channel over every rank's rows: the sum
    and then the centred sum of squares all-reduced over ``group``, both
    differentiable (`parallel.collectives.all_reduce_sum`), in fp32 sums."""
    dims = tuple(range(x.dim() - 1))
    count = x.numel() // x.shape[-1] * dist.get_world_size(group)
    mean = all_reduce_sum(x.sum(dim=dims, dtype=torch.float32), group) / count
    centred = x.float() - mean
    var = all_reduce_sum((centred * centred).sum(dim=dims), group) / count
    return mean.to(x.dtype), var.to(x.dtype)


def dense(x: torch.Tensor, params: DenseParams) -> torch.Tensor:
    return x @ params.kernel.to(x.dtype) + params.bias.to(x.dtype)


def global_average_pool(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NC."""
    return x.mean(dim=(1, 2))


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """Keras MaxPooling2D(pool_size=2, strides=None): VALID padding, NHWC."""
    return max_pool(x, (2, 2), (2, 2))


def max_pool(x: torch.Tensor, window: Tuple[int, int], strides: Tuple[int, int]) -> torch.Tensor:
    """Max pooling with VALID padding, NHWC (pad beforehand, with zeros,
    where the model pads)."""
    out = F.max_pool2d(x.permute(0, 3, 1, 2), tuple(window), tuple(strides))
    return out.permute(0, 2, 3, 1).contiguous()


def apply_fc_activation(x: torch.Tensor, fc_activation: Optional[str]) -> torch.Tensor:
    """Softmax over the last axis, or the `torch.nn.functional` function of
    that name (the JAX package looks the name up in `jax.nn`)."""
    if fc_activation is None:
        return x
    if fc_activation == "softmax":
        return torch.softmax(x, dim=-1)
    fn = getattr(F, fc_activation, None)
    if fn is None:
        raise ValueError(f"Unsupported fc_activation {fc_activation!r}.")
    return fn(x)


def l2_kernel_penalty(params, weight: float) -> torch.Tensor:
    """Keras-style L2 kernel regularization, ``weight * sum(k**2)`` over
    every kernel parameter: dense conv and fc kernels and the packed layers'
    free leaves (a, b, c, d, cross of either antisymmetric layout, whose
    dense-lower zeros add nothing; diag, cross).  Biases, batch-norm
    parameters and the constant gamma centre are not regularized, as in the
    JAX package's `l2_kernel_penalty`."""
    leaves = []

    def collect(p):
        if isinstance(p, (ConvParams, DenseParams)):
            leaves.append(p.kernel)
        elif isinstance(p, (Antisym3x3Params, Antisym3x3DenseParams)):
            leaves.extend([p.a, p.b, p.c, p.d, p.cross])
        elif isinstance(p, AntisymKxKParams):
            leaves.extend([p.diag, p.cross])
        elif isinstance(p, dict):
            for v in p.values():
                collect(v)
        elif isinstance(p, (list, tuple)) and not hasattr(p, "_fields"):
            for v in p:
                collect(v)

    collect(params)
    if not leaves:
        return torch.zeros(())
    return weight * sum(torch.sum(torch.square(leaf.float())) for leaf in leaves)
