"""Dynamic w8a8 int8 convolutions for serving and for the int8-forward
training steps, in PyTorch.

Port of `differential_equations_resnet_tpu/ops/quantize.py`.  The scheme is
the JAX package's:

- weights: symmetric int8, one scale per output channel for serving
  (`quantize_kernel_per_cout`) or one scale for the whole kernel in
  training (`quantize_kernel_per_tensor`, which keeps a skew-symmetric
  kernel exactly skew after rounding);
- activations: symmetric int8 with one scale per tensor, its absmax taken
  on the device at every call (`quantize_activations_per_tensor`);
- products: int8 x int8 summed in int32, then rescaled by the product of
  the two scales, plus the fp32 bias, and cast to the input's dtype.

The JAX package runs the integer convolutions on XLA; here they are im2col
matrix products on `torch._int_mm` (cuBLASLt's int8 GEMM on the card, a
plain integer product on the CPU), the patches gathered from zero-padded
shifted int8 views (`F.unfold` takes no int8).  Integer sums are exact, so
the int8 operands and the int32 accumulators are the same on the card, on
the CPU and in the JAX package for the same fp32 input.  The fp32 steps
keep the JAX package's order (``k / scale``, ``max(absmax, tiny) / 127``,
``zi * (s_y * scale) + bias``), every division by a tensor on the input's
device: CUDA divides by a host scalar as a multiplication by its
reciprocal, which can move the last bit.

Everything stays on the device (no ``.item()``, no branch on a value), so
an int8 train step captures in a CUDA graph and quantizes anew at every
replay.

The training steps are `torch.autograd.Function`\\ s with the JAX package's
four backward modes (`_BACKWARD_MODES`): 'ste' (the fp backward, the
quantizer differentiated as the identity), 'dgrad' (the data-gradient
conv in int8 against the transposed int8 kernel), 'wgrad' (the
weight-gradient correlation in int8 from the saved int8 activations, the
data gradient fp against the dequantized transposed kernel) and 'full'
(both in int8).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from differential_equations_resnet_tpu_torch import constant_cache
from differential_equations_resnet_tpu_torch.parallel.collectives import data_group
from differential_equations_resnet_tpu_torch.ops.conv import (
    conv2d_same,
    conv2d_same_vjp,
    relu_conv_vjp,
    same_padding,
)

_BACKWARD_MODES = ("ste", "dgrad", "wgrad", "full")
_TINY = torch.finfo(torch.float32).tiny


class QuantizedConvParams(NamedTuple):
    """Symmetric int8 conv weights.

    ``kernel_q``: int8, (..., kh, kw, c_in, c_out), any leading stack axes.
    ``scale``:    fp32, (..., c_out), the dequantization scale per c_out.
    ``bias``:     fp32, (..., c_out) or None, not quantized: it adds into the
                  rescaled accumulator."""

    kernel_q: torch.Tensor
    scale: torch.Tensor
    bias: Optional[torch.Tensor] = None


@constant_cache
def _int8_max(device: torch.device) -> torch.Tensor:
    """127.0 as a 0-d fp32 tensor on ``device``, made once per device (a
    host-to-device copy cannot be captured in a CUDA graph)."""
    with torch.inference_mode(False):
        return torch.tensor(127.0, dtype=torch.float32).to(device)


def _scale_of(absmax: torch.Tensor) -> torch.Tensor:
    """max(absmax, tiny) / 127: an all-zero tensor (or channel) gets a
    scale above 0, so that dividing by it gives 0, not 0/0."""
    return torch.clamp_min(absmax, _TINY) / _int8_max(absmax.device)


def _flushed(scale: torch.Tensor) -> torch.Tensor:
    """``scale`` with its subnormal values (the scale of an all-zero tensor,
    tiny / 127) set to 0, as XLA on the CPU and the TPU flushes them: the
    scales the JAX package returns.  What they multiply is 0 either way."""
    return scale.masked_fill(scale < _TINY, 0.0)


def _to_int8(values: torch.Tensor) -> torch.Tensor:
    """round-half-even, clipped to [-127, 127], as int8."""
    return torch.clamp(torch.round(values), -127, 127).to(torch.int8)


def quantize_kernel_per_cout(
    kernel: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> QuantizedConvParams:
    """Symmetric per-output-channel int8 quantization of an HWIO kernel,
    optionally with leading stack axes (the (L, 3, 3, C, C) trunk stack)."""
    k = kernel.float()
    scale = _scale_of(torch.amax(k.abs(), dim=(-4, -3, -2)))
    kq = _to_int8(k / scale[..., None, None, None, :])
    return QuantizedConvParams(kq, _flushed(scale), None if bias is None else bias.float())


def quantize_kernel_per_tensor(
    kernel: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> QuantizedConvParams:
    """Symmetric per-TENSOR int8 quantization of an HWIO kernel (optionally
    stacked: one scale per leading index).  One scale makes k -> q(k) odd,
    so a skew-centrosymmetric kernel quantizes to an exactly
    skew-centrosymmetric int8 kernel; the scale is broadcast to (...,
    c_out) so that consumers need no case split."""
    k = kernel.float()
    scale = _scale_of(torch.amax(k.abs(), dim=(-4, -3, -2, -1)))
    kq = _to_int8(k / scale[..., None, None, None, None])
    scale = _flushed(scale)[..., None].expand(*scale.shape, k.shape[-1])
    return QuantizedConvParams(kq, scale, None if bias is None else bias.float())


def absmax_groups(tp_group=None) -> Tuple:
    """The process groups a per-tensor scale's absmax is taken over: the
    data-parallel group of `parallel.collectives.data_parallel` (the whole
    batch's tensor, as the JAX package's step sharded over ``data`` takes
    it) and ``tp_group`` (a tensor split on channels); groups of one rank
    left out."""
    return tuple(g for g in (data_group(), tp_group)
                 if g is not None and dist.get_world_size(g) > 1)


def quantize_activations_per_tensor(y: torch.Tensor, groups=()) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-tensor int8 quantization: (y_q, scale) with
    ``y ~= y_q * scale``, the scale a 0-d fp32 tensor on y's device.  With
    process ``groups`` (`absmax_groups`), ``y`` is this rank's share of a
    tensor split over them, and the absmax is the whole tensor's (a max
    all-reduce over each)."""
    yf = y.float()
    absmax = yf.abs().amax()
    for group in groups:
        dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
    scale = _scale_of(absmax)
    return _to_int8(yf / scale), _flushed(scale)


def int8_matmul(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b_t (N, K)^T in int8 x int8 -> int32 by `torch._int_mm`,
    both operands K-major (the layout cuBLASLt's int8 GEMM takes).  Zero
    rows and columns pad what the card's GEMM needs (M > 16, K and N
    multiples of 8); integer zeros change no sum."""
    m, k = a.shape
    n = b_t.shape[0]
    pad_k = max(-(-k // 8) * 8, 8) - k
    pad_m, pad_n = max(17 - m, 0), -n % 8
    if pad_k or pad_m:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        b_t = F.pad(b_t, (0, pad_k, 0, pad_n))
    out = torch._int_mm(a.contiguous(), b_t.contiguous().t())
    return out[:m, :n] if (pad_m or pad_n) else out


def _patches(x: torch.Tensor, kh: int, kw: int, strides: Tuple[int, int]) -> torch.Tensor:
    """(N*Ho*Wo, kh*kw*C) patches of NHWC ``x`` under TF "SAME" padding at
    ``strides`` (the extra row and column after the image), in the HWIO
    kernel's (tap, channel) order."""
    n, h, w, c = x.shape
    sh, sw = strides
    top, bottom = same_padding(h, kh, sh)
    left, right = same_padding(w, kw, sw)
    ho, wo = -(-h // sh), -(-w // sw)
    if (kh, kw, top, bottom, left, right) == (1, 1, 0, 0, 0, 0):
        return x[:, ::sh, ::sw, :].reshape(n * ho * wo, c)
    xp = F.pad(x, (0, 0, left, right, top, bottom))
    taps = [xp[:, i:i + sh * (ho - 1) + 1:sh, j:j + sw * (wo - 1) + 1:sw, :]
            for i in range(kh) for j in range(kw)]
    return torch.stack(taps, dim=3).reshape(n * ho * wo, kh * kw * c)


def int8_conv_same(xq: torch.Tensor, kq: torch.Tensor,
                   strides: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """The int32 accumulator of the SAME conv of int8 NHWC ``xq`` with the
    int8 HWIO kernel ``kq``: XLA's ``conv_general_dilated(...,
    preferred_element_type=int32)`` as one im2col `int8_matmul`."""
    n, h, w, _ = xq.shape
    kh, kw, cin, cout = kq.shape
    ho, wo = -(-h // strides[0]), -(-w // strides[1])
    zi = int8_matmul(_patches(xq, kh, kw, strides), kq.reshape(kh * kw * cin, cout).t())
    return zi.reshape(n, ho, wo, cout)


def _dynamic_int8_conv_parts(
    y: torch.Tensor, qp: QuantizedConvParams, strides: Tuple[int, int] = (1, 1)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(z, y_q, s_y): the dynamic-w8a8 conv output and the quantized
    activations it consumed (the int8 backward modes keep them as their
    residual, 1 byte an element).  Inside a data-parallel step the
    activations' scale is the whole batch's (`absmax_groups`)."""
    yq, s_y = quantize_activations_per_tensor(y, absmax_groups())
    z = int8_conv_same(yq, qp.kernel_q, strides).float() * (s_y * qp.scale)
    if qp.bias is not None:
        z = z + qp.bias
    return z.to(y.dtype), yq, s_y


def dynamic_int8_conv_same(
    y: torch.Tensor, qp: QuantizedConvParams, strides: Tuple[int, int] = (1, 1)
) -> torch.Tensor:
    """SAME conv in dynamic w8a8: quantize ``y`` per tensor, conv int8 x
    int8 -> int32, rescale by (activation scale x per-c_out weight scale),
    add the fp32 bias, return in ``y.dtype``.  ``qp`` is one layer's
    (kernel_q (kh, kw, c_in, c_out), scale (c_out,))."""
    return _dynamic_int8_conv_parts(y, qp, strides)[0]


def transpose_int8_kernel(kernel_q: torch.Tensor) -> torch.Tensor:
    """The kernel of the adjoint conv: rot180 in (kh, kw) and the (c_in,
    c_out) swap, exact for stride-1 SAME odd kernels.  For an antisymmetric
    kernel quantized with one scale it is exactly ``-kernel_q``."""
    return kernel_q.flip(-4, -3).transpose(-1, -2)


def _int8_dgrad(g_z, kernel_q, k_scale, out_dtype, groups=()):
    """Data-gradient conv in w8a8: quantize the masked cotangent per
    tensor (over ``groups``, see `quantize_activations_per_tensor`), conv
    against the transposed int8 kernel, rescale.  Returns (dy_conv, g_q,
    s_g); the weight gradient reuses (g_q, s_g)."""
    g_q, s_g = quantize_activations_per_tensor(g_z, groups)
    di = int8_conv_same(g_q, transpose_int8_kernel(kernel_q))
    return (di.float() * (s_g * k_scale)).to(out_dtype), g_q, s_g


def _int8_wgrad(y_q, g_q, kernel_hw=(3, 3)):
    """The weight-gradient correlation in int8 x int8 -> int32 of the odd-k
    SAME stride-1 conv, ``dk[h, w, i, o] = sum_{n,r,c} y_pad[n, r+h-p,
    c+w-p, i] * g[n, r, c, o]``, in the JAX package's tap form
    (`_int8_wgrad_taps`): one (C_in, N*H*W) @ (N*H*W, C_out) product a tap
    over the overlap of the shifted activation and the cotangent (the SAME
    padding adds nothing there), bit-identical to the JAX conv form.  Both
    operands are laid out channel-major once, (C, N, H, W), so that every
    tap's slices are K-major GEMM operands without a transpose of their
    own."""
    _, hh, ww, cin = y_q.shape
    cout = g_q.shape[-1]
    kh, kw = kernel_hw
    y_t = y_q.permute(3, 0, 1, 2).contiguous()
    g_t = g_q.permute(3, 0, 1, 2).contiguous()
    taps = []
    for dh in range(-(kh // 2), kh // 2 + 1):
        for dw in range(-(kw // 2), kw // 2 + 1):
            ys = y_t[:, :, max(0, dh):hh + min(0, dh), max(0, dw):ww + min(0, dw)]
            gs = g_t[:, :, max(0, -dh):hh + min(0, -dh), max(0, -dw):ww + min(0, -dw)]
            taps.append(int8_matmul(ys.reshape(cin, -1), gs.reshape(cout, -1)))
    return torch.stack(taps).reshape(kh, kw, cin, cout)


def _check_int8_args(name, kernel, bias, weight_scale, backward):
    if bias is None:
        raise ValueError(
            f"{name} requires a bias tensor (got None); pass "
            "torch.zeros(channels) for a bias-free step."
        )
    if backward not in _BACKWARD_MODES:
        raise ValueError(f"backward must be one of {_BACKWARD_MODES}, got {backward!r}.")
    if backward != "ste" and weight_scale != "per_tensor":
        raise ValueError(
            "int8 backward modes require weight_scale='per_tensor' (the "
            "transposed conv's rescale needs a single kernel scale; "
            "per-c_out scales are on its contracting dimension)."
        )
    if backward != "ste":
        kh, kw = kernel.shape[-4], kernel.shape[-3]
        if kh % 2 == 0 or kw % 2 == 0:
            raise ValueError(
                f"{name}: int8 backward modes ('dgrad'/'wgrad'/'full') "
                f"require odd spatial kernel extents, got ({kh}, {kw}); "
                "use backward='ste' for even kernels."
            )


def _quantize_kernel(kernel, bias, weight_scale):
    if weight_scale == "per_tensor":
        return quantize_kernel_per_tensor(kernel, bias)
    if weight_scale == "per_cout":
        return quantize_kernel_per_cout(kernel, bias)
    raise ValueError(f"weight_scale must be 'per_tensor' or 'per_cout', got {weight_scale!r}.")


def _save_residuals(ctx, backward, y, kernel, yq, s_y, qp, *extra):
    """The mode's residuals (then ``extra``, the relu mask where there is
    one): 'ste' (y, kernel); 'dgrad' (y, kernel, kernel_q, k_scale);
    'wgrad'/'full' the int8 activations instead of the fp ones, (y_q, s_y,
    kernel_q, k_scale); and the groups the cotangent's scale is taken over
    (`absmax_groups` at the forward)."""
    ctx.backward, ctx.kernel_dtype = backward, kernel.dtype
    ctx.groups = absmax_groups(getattr(ctx, "tp_group", None))
    if backward == "ste":
        saved = (y, kernel)
    elif backward == "dgrad":
        saved = (y, kernel, qp.kernel_q, qp.scale[..., 0])
    else:
        saved = (yq, s_y, qp.kernel_q, qp.scale[..., 0])
    ctx.save_for_backward(*saved, *extra)


def _int8_linear_bwd(backward, saved, g_z, kernel_dtype, groups=()):
    """(dy_conv, dk, db) of ``z = int8conv(y, K) + b`` at ``g_z`` under the
    mode: everything downstream of the mode-independent ``g_z``.  'wgrad'
    takes the data gradient fp against the dequantized transposed kernel
    (no quantization noise on the residual stream); 'dgrad' and 'full'
    quantize the cotangent for it, with the scale of the whole cotangent
    over ``groups`` (the forward's `absmax_groups`)."""
    if backward == "ste":
        y, kernel = saved
        return relu_conv_vjp(y, kernel, g_z)
    db = g_z.sum(dim=(0, 1, 2))
    if backward == "dgrad":
        y, kernel, kq, k_scale = saved
        dy_conv, _, _ = _int8_dgrad(g_z, kq, k_scale, g_z.dtype, groups)
        _, dk = conv2d_same_vjp(y, kernel, g_z, need=(False, True))
        return dy_conv, dk, db
    yq, s_y, kq, k_scale = saved
    if backward == "wgrad":
        k_t = transpose_int8_kernel(kq).to(g_z.dtype)
        dy_conv = (conv2d_same(g_z, k_t).float() * k_scale).to(g_z.dtype)
        g_q, s_g = quantize_activations_per_tensor(g_z, groups)
    else:  # 'full'
        dy_conv, g_q, s_g = _int8_dgrad(g_z, kq, k_scale, g_z.dtype, groups)
    dk = (_int8_wgrad(yq, g_q, tuple(kq.shape[-4:-2])).float() * (s_y * s_g)).to(kernel_dtype)
    return dy_conv, dk, db


class _EulerReluStepInt8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, kernel, bias, h, weight_scale, backward):
        qp = _quantize_kernel(kernel, bias, weight_scale)
        z, yq, s_y = _dynamic_int8_conv_parts(y, qp)
        _save_residuals(ctx, backward, y, kernel, yq, s_y, qp, z > 0)
        ctx.h = h
        return y + h * torch.relu(z)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        *saved, mask = ctx.saved_tensors
        g_z = torch.where(mask, ctx.h * g, 0.0).to(g.dtype)
        dy_conv, dk, db = _int8_linear_bwd(ctx.backward, saved, g_z, ctx.kernel_dtype, ctx.groups)
        return g + dy_conv, dk, db, None, None, None


class _ConvInt8Same(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, kernel, bias, weight_scale, backward):
        qp = _quantize_kernel(kernel, bias, weight_scale)
        z, yq, s_y = _dynamic_int8_conv_parts(y, qp)
        _save_residuals(ctx, backward, y, kernel, yq, s_y, qp)
        return z

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        dy, dk, db = _int8_linear_bwd(ctx.backward, ctx.saved_tensors, g, ctx.kernel_dtype,
                                      ctx.groups)
        return dy, dk, db, None, None


class _ConvReluFieldInt8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, kernel, bias, weight_scale, backward):
        qp = _quantize_kernel(kernel, bias, weight_scale)
        z, yq, s_y = _dynamic_int8_conv_parts(y, qp)
        _save_residuals(ctx, backward, y, kernel, yq, s_y, qp, z > 0)
        return torch.relu(z)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        *saved, mask = ctx.saved_tensors
        g_z = torch.where(mask, g, 0.0).to(g.dtype)
        dy, dk, db = _int8_linear_bwd(ctx.backward, saved, g_z, ctx.kernel_dtype, ctx.groups)
        return dy, dk, db, None, None


def euler_relu_step_int8(y: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, h: float,
                         weight_scale: str = "per_tensor", backward: str = "ste"):
    """One forward-Euler step ``y + h * relu(int8conv(y, K) + b)`` with the
    dynamic-w8a8 forward conv (the kernel re-quantized at every call: it
    changes every update) and a bool relu-mask backward in the mode
    ``backward`` (module docstring).  'dgrad' and 'full' quantize the
    cotangent on the residual stream, which the JAX package measured
    diverging in training at lane-filling widths; 'wgrad' and 'ste' train.
    ``weight_scale``: 'per_tensor' (default; keeps the antisymmetric
    structure exactly) or 'per_cout' (serving's, 'ste' only).  ``bias`` must
    be a tensor."""
    _check_int8_args("euler_relu_step_int8", kernel, bias, weight_scale, backward)
    return _EulerReluStepInt8.apply(y, kernel, bias, h, weight_scale, backward)


def conv_int8_same(y: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                   weight_scale: str = "per_tensor", backward: str = "ste"):
    """A bare stride-1 SAME conv in dynamic w8a8 with a trainable backward
    (no relu): the training primitive of the bottleneck family's conv ->
    batch norm -> relu blocks.  Its backward is the two linear adjoints and
    ``db = sum(g)``, in the mode ``backward`` as in `euler_relu_step_int8`;
    odd kernels only for the int8 modes (1x1 and 3x3 qualify)."""
    _check_int8_args("conv_int8_same", kernel, bias, weight_scale, backward)
    return _ConvInt8Same.apply(y, kernel, bias, weight_scale, backward)


def conv_relu_field_int8(y: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                         weight_scale: str = "per_tensor", backward: str = "ste"):
    """One ODE field evaluation ``relu(int8conv(y, K) + b)``, the int8
    counterpart of `ops.conv.conv_relu_field` for the midpoint and RK4
    integrators, with the bool-mask backward in the mode ``backward``."""
    _check_int8_args("conv_relu_field_int8", kernel, bias, weight_scale, backward)
    return _ConvReluFieldInt8.apply(y, kernel, bias, weight_scale, backward)
