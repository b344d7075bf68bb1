"""Building blocks shared by the model families, in PyTorch.

Port of `differential_equations_resnet_tpu/models/blocks.py`.  Parameters are
NamedTuples of tensors in the JAX package's layouts (HWIO conv kernels,
(d_in, d_out) dense kernels).  Initializers follow TF-1.12 Keras: `he_normal`
is a truncated normal with stddev sqrt(2/fan_in), biases start at zero.  The
BatchNorm parameter types are declared so that trees holding them can be
read; batch norm itself waits for a later slice.  `l2_kernel_penalty` is the
training objective's Keras-style L2 term.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from differential_equations_resnet_tpu_torch.ops.antisymmetric import (
    Antisym3x3Params,
    he_truncated_normal,
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


def dense(x: torch.Tensor, params: DenseParams) -> torch.Tensor:
    return x @ params.kernel.to(x.dtype) + params.bias.to(x.dtype)


def global_average_pool(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NC."""
    return x.mean(dim=(1, 2))


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """Keras MaxPooling2D(pool_size=2, strides=None): VALID padding, NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1).contiguous()


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
    every kernel parameter: dense conv and fc kernels and the antisymmetric
    layers' free leaves (a, b, c, d, cross).  Biases, batch-norm parameters
    and the constant gamma centre are not regularized, as in the JAX
    package's `l2_kernel_penalty`."""
    leaves = []

    def collect(p):
        if isinstance(p, (ConvParams, DenseParams)):
            leaves.append(p.kernel)
        elif isinstance(p, Antisym3x3Params):
            leaves.extend([p.a, p.b, p.c, p.d, p.cross])
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
