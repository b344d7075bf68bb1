"""Convolutions with TF "SAME" padding on NHWC activations and HWIO kernels.

Port of `conv2d_same` in `differential_equations_resnet_tpu/ops/conv.py`.
The padding is explicit because TF pads asymmetrically at stride 2 (the
extra row and column go after the image) and PyTorch's ``padding='same'``
refuses strides above 1.  On CUDA the convolution runs with TF32 off.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _fp32_conv_context(x: torch.Tensor):
    """cuDNN with TF32 off for a convolution on ``x`` (a no-op on the CPU):
    cuDNN rounds fp32 convolutions to TF32 by default."""
    if x.is_cuda:
        return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)
    return contextlib.nullcontext()


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of TF "SAME": out = ceil(size / stride)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d_same(
    x: torch.Tensor,
    kernel: torch.Tensor,
    strides: Tuple[int, int] = (1, 1),
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """2-D convolution, NHWC input, HWIO kernel, zero ("SAME") padding.
    Returns a contiguous NHWC tensor."""
    kh, kw = kernel.shape[0], kernel.shape[1]
    sh, sw = strides
    top, bottom = same_padding(x.shape[1], kh, sh)
    left, right = same_padding(x.shape[2], kw, sw)
    nchw = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
    with _fp32_conv_context(x):
        out = F.conv2d(nchw, kernel.to(x.dtype).permute(3, 2, 0, 1), stride=(sh, sw))
    out = out.permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.contiguous()
