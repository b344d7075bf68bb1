"""Fused multi-layer forward-Euler integrator: the hand-written CUDA kernel
and its plain PyTorch version.

Counterpart of `differential_equations_resnet_tpu/ops/pallas/fused_integrator.py`
(forward only).  For NHWC fp32 x (B, H, W, C), dense HWIO kernels
(L, 3, 3, C, C) and biases (L, C) it computes

    y_0 = x,   y_{l+1} = y_l + h * relu(conv3x3_same(y_l, K_l) + b_l)

`fused_euler_dense` runs `reference_euler_dense` (a loop of `conv2d_same`
and relu) on CPU tensors, and on CUDA tensors launches the kernel of
``csrc/fused_euler_fwd.cu`` or raises: there is no fallback.  The kernel keeps
one image's zero-padded state in one thread block's shared memory for all L
layers, so its gate is the card's shared memory, not the TPU's VMEM: see
`fused_euler_eligible`.  The backward kernel is a later slice, so a CUDA call
that would need a gradient raises `NotImplementedError`; on the CPU the plain
version stays differentiable.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from differential_equations_resnet_tpu_torch.ops.antisymmetric import (
    Antisym3x3Params,
    materialize_3x3_stacked,
)
from differential_equations_resnet_tpu_torch.ops.conv import conv2d_same
from differential_equations_resnet_tpu_torch.ops.kernels import _build

# Dynamic shared memory one thread block may use on sm_90.
SMEM_LIMIT_BYTES = 232_448
# The JAX gate's own limits, kept: C <= 128 and H*W <= 64*64.
MAX_CHANNELS = 128
MAX_PIXELS = 64 * 64

_MATMUL_DTYPES = (torch.float32, torch.bfloat16)


def state_smem_bytes(height: int, width: int, channels: int) -> int:
    """Shared memory of one block: the zero-padded fp32 state, one layer's
    (9C, C) kernel and its bias."""
    return 4 * ((height + 2) * (width + 2) * channels + 9 * channels * channels + channels)


def _declined(x: torch.Tensor) -> str:
    """Why the kernel cannot take ``x``, or "" where it can."""
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
    need = state_smem_bytes(height, width, channels)
    if need > SMEM_LIMIT_BYTES:
        return (
            f"the padded state of a {height}x{width}x{channels} image needs "
            f"{need} bytes of shared memory, over the {SMEM_LIMIT_BYTES} one "
            "block may use"
        )
    return ""


def fused_euler_eligible(x: torch.Tensor, blocks) -> bool:
    """Whether the fused kernel takes this (shape, dtype, params) combination:
    a 4-D fp32 contiguous NHWC input, `Antisym3x3Params` with a bias,
    C <= 128, H*W <= 4096, and ``(H+2)(W+2)C*4 + 9C^2*4 + C*4 <= 232,448``
    bytes (one block's shared memory on sm_90).

    At 32x32 this admits C <= 38.  Unlike the JAX gate it declines
    64x64x16, whose padded state alone is 279 KB; a spatially tiled variant
    with a halo exchange is later work."""
    if not isinstance(blocks, Antisym3x3Params) or blocks.bias is None:
        return False
    return not _declined(x)


def reference_euler_dense(
    x: torch.Tensor,
    kernels: torch.Tensor,
    biases: torch.Tensor,
    h: float,
    matmul_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The plain version: L steps of `conv2d_same` and relu.  With
    ``matmul_dtype=torch.bfloat16`` the conv operands are rounded to bf16 and
    the conv runs in fp32, as the kernel's bf16 mode does."""
    y = x
    for layer in range(kernels.shape[0]):
        kernel = kernels[layer]
        patches = y
        if matmul_dtype == torch.bfloat16:
            patches = y.to(torch.bfloat16).to(y.dtype)
            kernel = kernel.to(torch.bfloat16).to(y.dtype)
        z = conv2d_same(patches, kernel, bias=biases[layer])
        y = y + h * torch.relu(z)
    return y


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with every function's C signature declared."""
    lib = _build.load("fused_euler_fwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.deqres_euler_fwd.argtypes = [
        ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ctypes.c_float, i32, ptr,
    ]
    lib.deqres_euler_fwd.restype = i32
    lib.deqres_euler_fwd_variant.argtypes = [i32, i32, i32]
    lib.deqres_euler_fwd_variant.restype = i32
    lib.deqres_cuda_error_string.argtypes = [i32]
    lib.deqres_cuda_error_string.restype = ctypes.c_char_p
    return lib


def kernel_variant(height: int, width: int, channels: int) -> str:
    """Which variant of the CUDA kernel a shape runs: "resident" (z in
    registers) or "staged" (new state parked in the output buffer)."""
    code = _library().deqres_euler_fwd_variant(height, width, channels)
    if code < 0:
        raise NotImplementedError(f"no kernel variant for {height}x{width}x{channels}")
    return "resident" if code == 1 else "staged"


def _launch(x, kernels, biases, h, matmul_dtype) -> torch.Tensor:
    reason = _declined(x)
    if reason:
        raise NotImplementedError(
            f"fused_euler_dense on CUDA declines this input: {reason}. A "
            "spatially tiled kernel for such shapes is ROADMAP item B1's "
            "later work."
        )
    batch, height, width, channels = x.shape
    num_layers = kernels.shape[0]
    if tuple(kernels.shape) != (num_layers, 3, 3, channels, channels):
        raise ValueError(f"kernels must be (L, 3, 3, {channels}, {channels}), got {tuple(kernels.shape)}")
    if tuple(biases.shape) != (num_layers, channels):
        raise ValueError(f"biases must be ({num_layers}, {channels}), got {tuple(biases.shape)}")
    for name, t in (("kernels", kernels), ("biases", biases)):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {x.device}, got {t.dtype} on {t.device}")
    if matmul_dtype not in _MATMUL_DTYPES:
        raise ValueError(f"matmul_dtype must be float32 or bfloat16, got {matmul_dtype}")
    kernels = kernels.contiguous()
    biases = biases.contiguous()
    out = torch.empty_like(x)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.deqres_euler_fwd(
            x.data_ptr(), kernels.data_ptr(), biases.data_ptr(), out.data_ptr(),
            batch, height, width, channels, num_layers, float(h),
            int(matmul_dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_euler_fwd launch failed: CUDA error {err} "
            f"({lib.deqres_cuda_error_string(err).decode()})"
        )
    fused_euler_dense.launches += 1
    return out


def fused_euler_dense(
    x: torch.Tensor,
    kernels: torch.Tensor,
    biases: torch.Tensor,
    h: float,
    matmul_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """y_L of L fused Euler steps with dense (L, 3, 3, C, C) kernels.

    CPU tensors take `reference_euler_dense`.  CUDA tensors launch the
    kernel, counted in ``fused_euler_dense.launches``, or raise:
    `NotImplementedError` for a shape the kernel declines or when a
    gradient would be needed (the backward kernel is ROADMAP item B2).
    ``matmul_dtype=torch.bfloat16`` rounds the conv operands to bf16 and
    keeps fp32 sums; the state y stays fp32 throughout."""
    if x.device.type == "cpu":
        return reference_euler_dense(x, kernels, biases, h, matmul_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_euler_dense runs on CPU or CUDA tensors, not {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, kernels, biases)):
        raise NotImplementedError(
            "fused_euler_dense on CUDA is forward-only: its backward kernel is "
            "ROADMAP item B2. Run under torch.no_grad() or torch.inference_mode()."
        )
    return _launch(x, kernels, biases, h, matmul_dtype)


fused_euler_dense.launches = 0


def fused_euler_3x3(
    x: torch.Tensor,
    blocks: Antisym3x3Params,
    h: float,
    gamma: float,
    matmul_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Fused L-layer Euler integration with packed antisymmetric parameters:
    the dense kernels are materialized first (differentiably)."""
    kernels = materialize_3x3_stacked(blocks, gamma=gamma)
    return fused_euler_dense(x, kernels, blocks.bias, float(h), matmul_dtype)
