"""Fused multi-layer forward-Euler integrator: the hand-written CUDA kernels
of its forward and backward, and their plain PyTorch versions.

Counterpart of `differential_equations_resnet_tpu/ops/pallas/fused_integrator.py`.
For NHWC fp32 x (B, H, W, C), dense HWIO kernels (L, 3, 3, C, C) and biases
(L, C) it computes

    y_0 = x,   y_{l+1} = y_l + h * relu(conv3x3_same(y_l, K_l) + b_l)

and, as the JAX custom VJP does, its gradient by recomputing the trajectory
from x: the autograd graph keeps only (x, kernels, biases), one state
whatever the depth.

`fused_euler_dense` is the entry point.  On CPU tensors it runs the plain
versions (`reference_euler_dense`, `reference_euler_dense_bwd`); on CUDA
tensors it launches the kernels of ``csrc/fused_euler_fwd.cu`` (B1) and
``csrc/fused_euler_bwd.cu`` (B2) or raises: there is no fallback.  Each kernel
keeps one image's zero-padded state in one thread block's shared memory, so
its gate is the card's shared memory, not the TPU's VMEM
(`fused_euler_eligible`, `fused_euler_bwd_eligible`).  Where a gradient will
be needed, a shape that B2 declines raises before B1 is launched.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from differential_equations_resnet_tpu_torch.ops.antisymmetric import (
    Antisym3x3Params,
    materialize_3x3_stacked,
)
from differential_equations_resnet_tpu_torch.ops.conv import (
    conv2d_same,
    relu_conv_vjp,
    round_operand,
)
from differential_equations_resnet_tpu_torch.ops.kernels import _build

# Dynamic shared memory one thread block may use on sm_90.
SMEM_LIMIT_BYTES = 232_448
# The JAX gate's own limits, kept: C <= 128 and H*W <= 64*64.
MAX_CHANNELS = 128
MAX_PIXELS = 64 * 64

_MATMUL_DTYPES = (torch.float32, torch.bfloat16)


def state_smem_bytes(height: int, width: int, channels: int) -> int:
    """Shared memory of one B1 block: the zero-padded fp32 state, one layer's
    (9C, C) kernel and its bias."""
    return 4 * ((height + 2) * (width + 2) * channels + 9 * channels * channels + channels)


def bwd_smem_bytes(height: int, width: int, channels: int) -> int:
    """Shared memory of one B2 block: the zero-padded y_l and g_z, one
    layer's kernel and its rotated transpose, and its bias."""
    return 4 * (2 * (height + 2) * (width + 2) * channels
                + 2 * 9 * channels * channels + channels)


def _declined(x: torch.Tensor, smem_bytes=state_smem_bytes) -> str:
    """Why a kernel whose block needs ``smem_bytes(H, W, C)`` of shared
    memory cannot take ``x``, or "" where it can."""
    if x.dim() != 4:
        return f"x must be 4-D NHWC, got shape {tuple(x.shape)}"
    if x.dtype != torch.float32:
        return f"x must be float32, got {x.dtype}"
    if not x.is_contiguous():
        return "x must be contiguous NHWC"
    _, height, width, channels = x.shape
    if channels > MAX_CHANNELS:
        return f"C={channels} > {MAX_CHANNELS}"
    if height * width > MAX_PIXELS:
        return f"H*W={height * width} > {MAX_PIXELS}"
    need = smem_bytes(height, width, channels)
    if need > SMEM_LIMIT_BYTES:
        return (
            f"one block needs {need} bytes of shared memory for a "
            f"{height}x{width}x{channels} image, over the {SMEM_LIMIT_BYTES} "
            "one block may use"
        )
    return ""


def fused_euler_eligible(x: torch.Tensor, blocks) -> bool:
    """Whether the forward kernel B1 takes this (shape, dtype, params)
    combination: a 4-D fp32 contiguous NHWC input, `Antisym3x3Params` with a
    bias, C <= 128, H*W <= 4096, and ``(H+2)(W+2)C*4 + 9C^2*4 + C*4 <=
    232,448`` bytes (one block's shared memory on sm_90).

    At 32x32 this admits C <= 38.  Unlike the JAX gate it declines
    64x64x16, whose padded state alone is 279 KB; a spatially tiled variant
    with a halo exchange is later work."""
    if not isinstance(blocks, Antisym3x3Params) or blocks.bias is None:
        return False
    return not _declined(x)


def fused_euler_bwd_eligible(x: torch.Tensor, blocks) -> bool:
    """Whether the backward kernel B2 takes this combination: B1's gate with
    ``2(H+2)(W+2)C*4 + 2*9C^2*4 + C*4 <= 232,448`` bytes (two padded states
    and two kernels a block).  At 32x32 this admits C <= 21."""
    if not isinstance(blocks, Antisym3x3Params) or blocks.bias is None:
        return False
    return not _declined(x, bwd_smem_bytes)


def _preactivation(y, kernel, bias, matmul_dtype):
    """z = conv2d_same(y, K) + b, operands rounded as ``matmul_dtype`` says."""
    return conv2d_same(
        round_operand(y, matmul_dtype), round_operand(kernel, matmul_dtype), bias=bias
    )


def reference_euler_dense(
    x: torch.Tensor,
    kernels: torch.Tensor,
    biases: torch.Tensor,
    h: float,
    matmul_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The plain version of B1: L steps of `conv2d_same` and relu.  With
    ``matmul_dtype=torch.bfloat16`` the conv operands are rounded to bf16 and
    the conv runs in fp32, as the kernel's bf16 mode does."""
    y = x
    for layer in range(kernels.shape[0]):
        y = y + h * torch.relu(_preactivation(y, kernels[layer], biases[layer], matmul_dtype))
    return y


def reference_euler_dense_bwd(
    x: torch.Tensor,
    kernels: torch.Tensor,
    biases: torch.Tensor,
    g: torch.Tensor,
    h: float,
    matmul_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of B2: (gx, gk, gb), the cotangents of x, kernels
    and biases for the cotangent g of y_L.  It recomputes the trajectory with
    `conv2d_same`, then walks the layers in reverse with the relu-mask
    formulas of `ops.conv.euler_relu_step`'s backward, recomputing z as B2
    does.  In bf16 mode the forward recompute and the transposed convolution
    take bf16 operands; dK and db stay fp32, as in the Pallas kernel."""
    num_layers = kernels.shape[0]
    trajectory = [x]
    for layer in range(num_layers - 1):
        z = _preactivation(trajectory[-1], kernels[layer], biases[layer], matmul_dtype)
        trajectory.append(trajectory[-1] + h * torch.relu(z))
    gk, gb = torch.zeros_like(kernels), torch.zeros_like(biases)
    for layer in reversed(range(num_layers)):
        y = trajectory[layer]
        z = _preactivation(y, kernels[layer], biases[layer], matmul_dtype)
        g_z = torch.where(z > 0, h * g, 0.0)
        dy, gk[layer], gb[layer] = relu_conv_vjp(y, kernels[layer], g_z, matmul_dtype)
        g = g + dy
    return g, gk, gb


_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (argtypes, restype) of every C function of each kernel library.
_SIGNATURES = {
    "fused_euler_fwd": {
        "deqres_euler_fwd": ([_PTR] * 4 + [_I32] * 5 + [_F32, _I32, _PTR], _I32),
        "deqres_euler_fwd_variant": ([_I32] * 3, _I32),
        "deqres_cuda_error_string": ([_I32], ctypes.c_char_p),
    },
    "fused_euler_bwd": {
        "deqres_euler_bwd": ([_PTR] * 9 + [_I32] * 5 + [_F32, _I32, _PTR], _I32),
        "deqres_euler_bwd_variant": ([_I32] * 3, _I32),
        "deqres_cuda_error_string": ([_I32], ctypes.c_char_p),
    },
}


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    """The built kernel library ``name`` with every function's C signature
    declared."""
    lib = _build.load(name)
    for function, (argtypes, restype) in _SIGNATURES[name].items():
        getattr(lib, function).argtypes = argtypes
        getattr(lib, function).restype = restype
    return lib


def kernel_variant(height: int, width: int, channels: int, backward: bool = False) -> str:
    """Which variant of B1 (or of B2 with ``backward=True``) a shape runs:
    "resident" (per-pixel sums in registers) or "staged" (any C)."""
    lib = _library("fused_euler_bwd" if backward else "fused_euler_fwd")
    variant = lib.deqres_euler_bwd_variant if backward else lib.deqres_euler_fwd_variant
    code = variant(height, width, channels)
    if code < 0:
        raise NotImplementedError(f"no kernel variant for {height}x{width}x{channels}")
    return "resident" if code == 1 else "staged"


def _check_operands(x, kernels, biases, matmul_dtype, reason, which):
    if reason:
        raise NotImplementedError(
            f"{which} on CUDA declines this input: {reason}. A spatially tiled "
            "kernel for such shapes is later work (ROADMAP B1)."
        )
    channels, num_layers = x.shape[-1], kernels.shape[0]
    if tuple(kernels.shape) != (num_layers, 3, 3, channels, channels):
        raise ValueError(f"kernels must be (L, 3, 3, {channels}, {channels}), got {tuple(kernels.shape)}")
    if tuple(biases.shape) != (num_layers, channels):
        raise ValueError(f"biases must be ({num_layers}, {channels}), got {tuple(biases.shape)}")
    for name, t in (("kernels", kernels), ("biases", biases)):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {x.device}, got {t.dtype} on {t.device}")
    if matmul_dtype not in _MATMUL_DTYPES:
        raise ValueError(f"matmul_dtype must be float32 or bfloat16, got {matmul_dtype}")


def _raise_on_error(lib, err, which):
    if err != 0:
        raise RuntimeError(
            f"{which} launch failed: CUDA error {err} "
            f"({lib.deqres_cuda_error_string(err).decode()})"
        )


def _launch(x, kernels, biases, h, matmul_dtype) -> torch.Tensor:
    _check_operands(x, kernels, biases, matmul_dtype, _declined(x), "fused_euler_dense")
    batch, height, width, channels = x.shape
    kernels = kernels.contiguous()
    biases = biases.contiguous()
    out = torch.empty_like(x)
    lib = _library("fused_euler_fwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.deqres_euler_fwd(
            x.data_ptr(), kernels.data_ptr(), biases.data_ptr(), out.data_ptr(),
            batch, height, width, channels, kernels.shape[0], float(h),
            int(matmul_dtype == torch.bfloat16), stream,
        )
    _raise_on_error(lib, err, "fused_euler_fwd")
    fused_euler_dense.launches += 1
    return out


def _launch_bwd(x, kernels, biases, g, h, matmul_dtype):
    _check_operands(x, kernels, biases, matmul_dtype, _declined(x, bwd_smem_bytes),
                    "fused_euler_dense_bwd")
    batch, height, width, channels = x.shape
    num_layers = kernels.shape[0]
    if num_layers < 1:
        raise ValueError("the backward kernel needs at least one layer")
    if g.shape != x.shape or g.dtype != torch.float32 or g.device != x.device:
        raise ValueError(f"g must be float32 {tuple(x.shape)} on {x.device}, got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")
    g = g.contiguous()
    kernels = kernels.contiguous()
    # Conv-transpose kernel: rot180 in (dh, dw), swap (c_in, c_out).
    kernels_t = kernels.flip(1, 2).transpose(3, 4).contiguous()
    biases = biases.contiguous()
    gx = torch.empty_like(x)
    gk = x.new_empty((batch, num_layers, 9, channels, channels))
    gb = x.new_empty((batch, num_layers, channels))
    trajectory = x.new_empty((num_layers, *x.shape))
    lib = _library("fused_euler_bwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.deqres_euler_bwd(
            x.data_ptr(), kernels.data_ptr(), kernels_t.data_ptr(), biases.data_ptr(),
            g.data_ptr(), gx.data_ptr(), gk.data_ptr(), gb.data_ptr(),
            trajectory.data_ptr(), batch, height, width, channels, num_layers, float(h),
            int(matmul_dtype == torch.bfloat16), stream,
        )
    _raise_on_error(lib, err, "fused_euler_bwd")
    fused_euler_dense_bwd.launches += 1
    # Per-image partials summed here, where the JAX wrapper sums its tiles'.
    return gx, gk.sum(dim=0).reshape(kernels.shape), gb.sum(dim=0)


def _device_type(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_euler_dense runs on CPU or CUDA tensors, not {x.device}")
    return x.device.type


def _forward(x, kernels, biases, h, matmul_dtype):
    if _device_type(x) == "cpu":
        return reference_euler_dense(x, kernels, biases, h, matmul_dtype)
    return _launch(x, kernels, biases, h, matmul_dtype)


def fused_euler_dense_bwd(
    x: torch.Tensor,
    kernels: torch.Tensor,
    biases: torch.Tensor,
    g: torch.Tensor,
    h: float,
    matmul_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gx, gk, gb) of `fused_euler_dense` at the cotangent g of y_L.  CPU
    tensors take `reference_euler_dense_bwd`; CUDA tensors launch B2,
    counted in ``fused_euler_dense_bwd.launches``, or raise."""
    if _device_type(x) == "cpu":
        return reference_euler_dense_bwd(x, kernels, biases, g, h, matmul_dtype)
    return _launch_bwd(x, kernels, biases, g, h, matmul_dtype)


fused_euler_dense_bwd.launches = 0


class FusedEulerDense(torch.autograd.Function):
    """B1 forward, B2 backward; the graph keeps (x, kernels, biases) only."""

    @staticmethod
    def forward(ctx, x, kernels, biases, h, matmul_dtype):
        if x.device.type == "cuda" and any(ctx.needs_input_grad[:3]):
            reason = _declined(x, bwd_smem_bytes)
            if reason:
                raise NotImplementedError(
                    "fused_euler_dense on CUDA cannot differentiate this input: "
                    f"its backward kernel B2 declines it ({reason}). Run under "
                    "torch.no_grad() for the forward alone."
                )
        ctx.save_for_backward(x, kernels, biases)
        ctx.h, ctx.matmul_dtype = h, matmul_dtype
        return _forward(x, kernels, biases, h, matmul_dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, kernels, biases = ctx.saved_tensors
        gx, gk, gb = fused_euler_dense_bwd(x, kernels, biases, g, ctx.h, ctx.matmul_dtype)
        return gx, gk, gb, None, None


def fused_euler_dense(
    x: torch.Tensor,
    kernels: torch.Tensor,
    biases: torch.Tensor,
    h: float,
    matmul_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """y_L of L fused Euler steps with dense (L, 3, 3, C, C) kernels.

    CPU tensors take the plain versions.  CUDA tensors launch B1, counted in
    ``fused_euler_dense.launches`` (and B2 in the backward), or raise
    `NotImplementedError` for a shape a kernel declines that this call needs.
    ``matmul_dtype=torch.bfloat16`` rounds the conv operands to bf16 and
    keeps fp32 sums; the state y stays fp32 throughout."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, kernels, biases)):
        return FusedEulerDense.apply(x, kernels, biases, h, matmul_dtype)
    return _forward(x, kernels, biases, h, matmul_dtype)


fused_euler_dense.launches = 0


def fused_euler_3x3(
    x: torch.Tensor,
    blocks: Antisym3x3Params,
    h: float,
    gamma: float,
    matmul_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Fused L-layer Euler integration with packed antisymmetric parameters:
    the dense kernels are materialized first, differentiably, so the dense
    kernel gradient folds back onto the packed leaves through autograd."""
    kernels = materialize_3x3_stacked(blocks, gamma=gamma)
    return fused_euler_dense(x, kernels, blocks.bias, float(h), matmul_dtype)
