"""Convolutions with TF "SAME" padding on NHWC activations and HWIO kernels,
and the Euler residual step and ODE field with a relu-mask backward.

Port of `differential_equations_resnet_tpu/ops/conv.py`: `conv2d_same`,
`conv2d_valid`, `antisym_conv2d_3x3` (either antisymmetric layout),
`euler_relu_step` and `conv_relu_field`.  The "SAME" padding is explicit
because TF pads asymmetrically at stride 2 (the extra row and column go after
the image) and PyTorch's ``padding='same'`` refuses strides above 1.

On CUDA every convolution here runs with TF32 off, its backward included:
`conv2d_same` is an autograd Function whose backward enters the same cuDNN
context (autograd would otherwise run the backward at ``loss.backward()``,
outside it, where cuDNN rounds fp32 to TF32 by default).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from differential_equations_resnet_tpu_torch.ops.antisymmetric import (
    Antisym3x3DenseParams,
    Antisym3x3Params,
    materialize_3x3,
    materialize_3x3_from_dense,
)


@contextlib.contextmanager
def cudnn_tf32_off():
    """cuDNN's ``allow_tf32`` off inside, restored on exit; every other cuDNN
    flag (``enabled``, ``deterministic``, ``benchmark`` and the rest) stays
    as the caller set it.  ``torch.backends.cudnn.flags`` is not used: it
    resets each flag it is not given to its default."""
    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = saved


def _fp32_conv_context(x: torch.Tensor):
    """cuDNN with TF32 off for a convolution on ``x`` (a no-op on the CPU):
    cuDNN rounds fp32 convolutions to TF32 by default."""
    return cudnn_tf32_off() if x.is_cuda else contextlib.nullcontext()


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of TF "SAME": out = ceil(size / stride)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _padded_nchw(x: torch.Tensor, kernel_hw: Tuple[int, int], strides: Tuple[int, int],
                 padding: str = "SAME"):
    """x (NHWC) as NCHW with its "SAME" padding (none for "VALID"), and
    (top, left)."""
    if padding == "VALID":
        return x.permute(0, 3, 1, 2), (0, 0)
    top, bottom = same_padding(x.shape[1], kernel_hw[0], strides[0])
    left, right = same_padding(x.shape[2], kernel_hw[1], strides[1])
    return F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom)), (top, left)


def conv2d_same_vjp(
    x: torch.Tensor,
    kernel: torch.Tensor,
    g: torch.Tensor,
    strides: Tuple[int, int] = (1, 1),
    need: Tuple[bool, bool] = (True, True),
    padding: str = "SAME",
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(dx, dK) of ``conv2d_same(x, kernel, strides)`` (no bias; of
    `conv2d_valid` with ``padding="VALID"``) at the NHWC cotangent ``g``: the
    transposed convolution of g with K, and the correlation of x with g.
    ``need`` says which of the two to compute (the other is None); dx needs
    only x's shape.  TF32 off on the card."""
    kh, kw = kernel.shape[0], kernel.shape[1]
    padded, (top, left) = _padded_nchw(x, (kh, kw), strides, padding)
    with _fp32_conv_context(x):
        dpad, dk, _ = torch.ops.aten.convolution_backward(
            g.permute(0, 3, 1, 2), padded, kernel.to(x.dtype).permute(3, 2, 0, 1),
            None, list(strides), [0, 0], [1, 1], False, [0, 0], 1, [need[0], need[1], False],
        )
    dx = dk_hwio = None
    if need[0]:
        dx = dpad[:, :, top:top + x.shape[1], left:left + x.shape[2]].permute(0, 2, 3, 1)
    if need[1]:
        dk_hwio = dk.permute(2, 3, 1, 0)
    return dx, dk_hwio


class _Conv2d(torch.autograd.Function):
    """A convolution without bias, "SAME" or "VALID", forward and backward
    both with TF32 off."""

    @staticmethod
    def forward(ctx, x, kernel, strides, padding):
        padded, _ = _padded_nchw(x, kernel.shape[:2], strides, padding)
        with _fp32_conv_context(x):
            out = F.conv2d(padded, kernel.permute(3, 2, 0, 1), stride=strides)
        ctx.save_for_backward(x, kernel)
        ctx.strides, ctx.padding = strides, padding
        return out.permute(0, 2, 3, 1)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        dx, dk = conv2d_same_vjp(x, kernel, g, ctx.strides, tuple(ctx.needs_input_grad[:2]),
                                 ctx.padding)
        return dx, dk, None, None


def conv2d_same(
    x: torch.Tensor,
    kernel: torch.Tensor,
    strides: Tuple[int, int] = (1, 1),
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """2-D convolution, NHWC input, HWIO kernel, zero ("SAME") padding.
    Returns a contiguous NHWC tensor."""
    out = _Conv2d.apply(x, kernel.to(x.dtype), tuple(strides), "SAME")
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.contiguous()


def conv2d_valid(
    x: torch.Tensor,
    kernel: torch.Tensor,
    strides: Tuple[int, int] = (1, 1),
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """2-D convolution with "VALID" padding (the bottleneck stem's, after an
    explicit zero pad).  Returns a contiguous NHWC tensor."""
    out = _Conv2d.apply(x, kernel.to(x.dtype), tuple(strides), "VALID")
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.contiguous()


def antisym_conv2d_3x3(
    x: torch.Tensor,
    params: Union[Antisym3x3Params, Antisym3x3DenseParams],
    gamma: float = 0.0,
    strides: Tuple[int, int] = (1, 1),
) -> torch.Tensor:
    """Antisymmetric 3x3 conv: the dense kernel materialized from either
    layout (the dense-lower one without a scatter), "SAME" conv, + bias."""
    if isinstance(params, Antisym3x3DenseParams):
        kernel = materialize_3x3_from_dense(params, gamma)
    else:
        kernel = materialize_3x3(params, gamma)
    return conv2d_same(x, kernel, strides=strides, bias=params.bias)


def round_operand(t: torch.Tensor, matmul_dtype: torch.dtype) -> torch.Tensor:
    """t with its values rounded to bf16 (kept in t's dtype) where
    ``matmul_dtype`` is torch.bfloat16; t itself otherwise."""
    return t.to(torch.bfloat16).to(t.dtype) if matmul_dtype == torch.bfloat16 else t


def relu_conv_vjp(
    y: torch.Tensor,
    kernel: torch.Tensor,
    g_z: torch.Tensor,
    matmul_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three linear cotangents of ``z = conv2d_same(y, K) + b`` at g_z:
    ``(conv_transpose(g_z, K), correlate(y, g_z), sum(g_z))``.  With
    ``matmul_dtype=torch.bfloat16`` the transposed convolution takes bf16
    operands (fp32 sums) and the correlation stays fp32, as the Pallas
    backward kernel does."""
    dy, _ = conv2d_same_vjp(
        y, round_operand(kernel, matmul_dtype), round_operand(g_z, matmul_dtype),
        need=(True, False),
    )
    _, dk = conv2d_same_vjp(y, kernel, g_z, need=(False, True))
    return dy, dk, g_z.sum(dim=(0, 1, 2))


class _EulerReluStep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, kernel, bias, h):
        z = conv2d_same(y, kernel, bias=bias)
        ctx.save_for_backward(y, kernel, z > 0)
        ctx.h = h
        return y + h * torch.relu(z)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        y, kernel, mask = ctx.saved_tensors
        g_z = torch.where(mask, ctx.h * g, 0.0)
        dy, dk, db = relu_conv_vjp(y, kernel, g_z)
        return g + dy, dk, db, None


class _ConvReluField(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, kernel, bias):
        z = conv2d_same(y, kernel, bias=bias)
        ctx.save_for_backward(y, kernel, z > 0)
        return torch.relu(z)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        y, kernel, mask = ctx.saved_tensors
        return relu_conv_vjp(y, kernel, torch.where(mask, g, 0.0))


def euler_relu_step(y: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, h: float):
    """One forward-Euler residual step ``y + h * relu(conv(y, K) + b)`` whose
    backward keeps a bool relu mask (1 byte an element) instead of the fp32
    pre-activation z:

        g_z = h * relu'(z) * g
        dy  = g + conv_transpose(g_z, K)
        dK  = correlate(y, g_z)
        db  = sum(g_z)

    ``bias`` must be a tensor; pass ``torch.zeros(C)`` for a bias-free step."""
    if bias is None:
        raise ValueError(
            "euler_relu_step requires a bias tensor (got None); pass "
            "torch.zeros(channels) for a bias-free step."
        )
    return _EulerReluStep.apply(y, kernel, bias, h)


def conv_relu_field(y: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor):
    """One ODE field evaluation ``relu(conv(y, K) + b)`` with the same
    bool-mask backward as `euler_relu_step` (the building block of the
    midpoint and RK4 integrators).  ``bias`` must be a tensor."""
    if bias is None:
        raise ValueError(
            "conv_relu_field requires a bias tensor (got None); pass "
            "torch.zeros(channels) for a bias-free field."
        )
    return _ConvReluField.apply(y, kernel, bias)
