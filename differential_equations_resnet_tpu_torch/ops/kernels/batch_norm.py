"""Train-mode batch norm of an NHWC tensor on one rank, with the op that
follows it: the hand-written CUDA kernels of its forward and backward
(``csrc/batch_norm.cu``), and their plain PyTorch versions, the yardstick
the kernels are held to.

Replaces no kernel of the JAX package, which leaves batch norm to XLA: the
composite of torch ops that `models.blocks.batch_norm` ran in train mode
took about 40% of ResNet-50's train step on an H100 (PERF.md).  For x
(..., C), scale and offset (C) and the running mean and variance (C) it
computes what that composite computes:

    y = (x - mean) * rsqrt(var + epsilon) * scale + offset

with mean and the biased variance over every axis but the last, the new
running statistics ``momentum * old + (1 - momentum) * batch``, and, in the
backward, in closed form from the saved x, mean and inv (xhat is not saved),

    doffset = sum dy,   dscale = sum dy * xhat,   xhat = (x - mean) * inv
    dx = scale * inv * (dy - doffset / M - xhat * dscale / M)

over the M rows.  The forward is the composite's bit for bit: mean and
variance from `torch.var_mean`, the same reduction the composite ran, and
y and the running statistics in its order of fp32 operations, because
ResNet-50's relu and max-pool masks turn any other rounding of the
statistics into gradients 4e-3 to 7e-3 apart (PERF.md, PR 22).  The
backward's two sums are fp64 in both versions; everything else is in x's
dtype.

The epilogue is the op that follows the batch norm in the model, which
the apply writes in its own pass (`EPILOGUES`): "none" (out = y), "relu"
(out = torch.relu(y)) or "add_relu" (out = torch.relu(y + residual), the
residual a second input).  Each gives the bits of those torch ops: the add
rounds as torch's does and the relu is torch.relu's, a NaN and the sign
of a zero included, so a model's activations are the separate ops' bit
for bit.  The backward zeroes the gradient where relu's output is 0,
threshold_backward's rule: for "relu" the kernels' two passes recompute
y from the x they read and mask there (no more launches); for "add_relu"
one `threshold_backward` masks it before the kernels, and that masked
gradient is also the residual's.  Either way the kernels see the gradient
the separate ops would have given them, so the backward's values are
theirs bit for bit.  The kernels move seven passes over x (the apply's
read and write, the backward's two reads and the apply's two reads and a
write), and an "add_relu" layer's apply reads its residual too.

`fused_batch_norm` is the entry point, for CUDA tensors (contiguous,
fp32) only: `torch.var_mean` and one apply launch forward and three
launches backward (sums, finalize, apply), each call reported, as kernel
"BN" with x's shape and variant "forward" or "backward", suffixed with
``+relu`` or ``+add_relu`` where the kernels ran that epilogue
(`variant`), to the record of hand-kernel calls (`utils.tracing.STACKS`,
which counts a captured graph's launches at each replay).  The plain
versions (`reference_batch_norm`, `reference_batch_norm_bwd`) are not a
route: `models.blocks.batch_norm` sends every other call to its composite
of torch ops and applies the epilogue after it (`epilogue_of`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from differential_equations_resnet_tpu_torch.ops.kernels import _build
from differential_equations_resnet_tpu_torch.ops.kernels.fused_integrator import (
    SM_COUNT,
    _sm_count,
)
from differential_equations_resnet_tpu_torch.utils.tracing import STACKS, StackEntry

# Threads a block (csrc/batch_norm.cu's kThreads) and the blocks an SM the
# plan aims at.
THREADS = 256
BLOCKS_PER_SM = 4
# The apply's epilogues, by their code in csrc/batch_norm.cu (`Epilogue`).
EPILOGUES = ("none", "relu", "add_relu")


def variant(direction: str, epilogue: str) -> str:
    """The record's variant of a call: "forward" or "backward", with
    ``+relu`` or ``+add_relu`` where the kernels ran that epilogue."""
    return direction if epilogue == "none" else f"{direction}+{epilogue}"


def _check_epilogue(epilogue: str, residual) -> None:
    if epilogue not in EPILOGUES or (epilogue == "add_relu") != (residual is not None):
        raise ValueError(f"epilogue must be one of {EPILOGUES}, with a residual for "
                         f"'add_relu' only; got {epilogue!r}, residual {residual is not None}")


def epilogue_of(y: torch.Tensor, epilogue: str, residual=None) -> torch.Tensor:
    """The epilogue as the torch ops it stands for: y, torch.relu(y) or
    torch.relu(y + residual)."""
    _check_epilogue(epilogue, residual)
    if epilogue == "relu":
        return torch.relu(y)
    if epilogue == "add_relu":
        return torch.relu(y + residual)
    return y


def bn_plan(rows: int, channels: int, aligned: bool = True, sms: int = SM_COUNT) -> dict:
    """The kernels' launch over an (rows, channels) tensor: ``vec`` channels
    a thread (4 where C % 4 == 0 and the tensors are 16-byte aligned, else
    1), ``lanes`` threads across a group of ``lanes * vec`` channels (the
    least power of two that covers C, at most 32), ``groups`` such groups,
    and ``chunks`` chunks of ``chunk`` rows: about `BLOCKS_PER_SM` blocks an
    SM, and no more chunks than give each thread a row."""
    vec = 4 if channels % 4 == 0 and aligned else 1
    lanes = min(32, 1 << (-(-channels // vec) - 1).bit_length())
    groups = -(-channels // (lanes * vec))
    step = THREADS // lanes
    chunks = max(1, min(-(-rows // step), -(-BLOCKS_PER_SM * sms // groups)))
    chunk = -(-rows // chunks)
    return dict(vec=vec, lanes=lanes, groups=groups, chunks=-(-rows // chunk), chunk=chunk)


def _moments(x):
    """(biased variance, mean) over every axis but the last: the composite's
    reduction, which the kernels' forward takes too."""
    return torch.var_mean(x, dim=tuple(range(x.dim() - 1)), correction=0)


def reference_batch_norm(x, scale, offset, mean, var, epsilon: float, momentum: float,
                         epilogue: str = "none", residual=None):
    """The forward's plain version, the composite's arithmetic and then the
    epilogue's torch ops: (out, stats), stats (4, C) the batch mean, inv =
    rsqrt(batch variance + epsilon), the new running mean and the new
    running variance."""
    batch_var, batch_mean = _moments(x)
    inv = torch.rsqrt(batch_var + epsilon)
    y = (x - batch_mean) * inv * scale + offset
    stats = torch.stack([batch_mean, inv,
                         momentum * mean + (1.0 - momentum) * batch_mean,
                         momentum * var + (1.0 - momentum) * batch_var])
    return epilogue_of(y, epilogue, residual), stats


def reference_batch_norm_bwd(dy, x, stats, scale, offset=None, epilogue: str = "none"):
    """The backward's plain version: (dx, dscale, doffset) in closed form
    from the saved x and the forward's ``stats``; the two sums in fp64, dx
    from per-channel factors rounded to x's dtype: ``a g + b (x - mean) +
    d``.  g is dy, or for ``epilogue`` "relu" dy zeroed where y, recomputed
    from x, ``stats`` and ``offset`` as the forward computed it, is <= 0
    (an "add_relu" caller masks dy itself, as `FusedBatchNorm` does)."""
    channels = x.shape[-1]
    if epilogue == "relu":
        y = (x - stats[0]) * stats[1] * scale + offset
        dy = torch.where(y <= 0, torch.zeros_like(dy), dy)
    elif epilogue != "none":
        raise ValueError(f"the backward's epilogue is 'none' or 'relu', got {epilogue!r}")
    rows, g = x.reshape(-1, channels), dy.reshape(-1, channels)
    mean, inv = stats[0], stats[1].double()
    doffset = g.double().sum(0)
    dscale = inv * (g.double() * (rows.double() - mean.double())).sum(0)
    a = scale.double() * inv
    factors = [f.to(x.dtype) for f in (a, -a * inv * dscale / len(rows), -a * doffset / len(rows))]
    dx = factors[0] * g + (factors[1] * (rows - mean) + factors[2])
    return dx.reshape(x.shape), dscale.to(x.dtype), doffset.to(x.dtype)


_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (argtypes, restype) of every C function of the library.
_SIGNATURES = {
    "deqres_bn_fwd": ([_PTR] * 10 + [_I32] * 7 + [_F32] * 3 + [_PTR], _I32),
    "deqres_bn_bwd": ([_PTR] * 10 + [_I32] * 7 + [_PTR], _I32),
    "deqres_cuda_error_string": ([_I32], ctypes.c_char_p),
}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with every function's C signature declared."""
    lib = _build.load("batch_norm")
    for function, (argtypes, restype) in _SIGNATURES.items():
        getattr(lib, function).argtypes = argtypes
        getattr(lib, function).restype = restype
    return lib


def _plan(x: torch.Tensor, *tensors: torch.Tensor) -> dict:
    rows = x.numel() // x.shape[-1]
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, *tensors))
    return bn_plan(rows, x.shape[-1], aligned, _sm_count(x.device.index or 0))


def _check(x: torch.Tensor, **per_channel: torch.Tensor) -> None:
    if (not x.is_cuda or x.dtype != torch.float32 or not x.is_contiguous() or x.dim() < 1
            or x.numel() == 0):
        raise ValueError(f"the batch-norm kernels take a non-empty contiguous float32 CUDA "
                         f"tensor, got {x.dtype} on {x.device}, shape {tuple(x.shape)}, "
                         f"contiguous {x.is_contiguous()}")
    for name, t in per_channel.items():
        if t.dtype != torch.float32 or t.device != x.device or tuple(t.shape) != x.shape[-1:]:
            raise ValueError(f"{name} must be float32 ({x.shape[-1]},) on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _report(x: torch.Tensor, variant: str, launches: int) -> None:
    """A call on the card to the record (`utils.tracing.STACKS`), into the
    graph being captured on the current stream if any."""
    STACKS.add(StackEntry("BN", tuple(x.shape), variant, 0, launches),
               torch.cuda.is_current_stream_capturing())


def _raise_on_error(lib, result: int, which: str) -> int:
    if result < 0:
        raise RuntimeError(f"{which} launch failed: CUDA error {-result} "
                           f"({lib.deqres_cuda_error_string(-result).decode()})")
    return result


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch(x, scale, offset, mean, var, epsilon: float, momentum: float,
            epilogue: str = "none", residual=None):
    """The forward on CUDA tensors, `torch.var_mean` then the apply launch
    with ``epilogue`` (``residual``, x's shape, for "add_relu"): (out,
    stats)."""
    scale, offset, mean, var = (t.contiguous() for t in (scale, offset, mean, var))
    _check(x, scale=scale, offset=offset, mean=mean, var=var)
    _check_epilogue(epilogue, residual)
    if residual is not None:
        residual = residual.contiguous()
        _check(residual)
        if residual.shape != x.shape or residual.device != x.device:
            raise ValueError(f"the residual {tuple(residual.shape)} on {residual.device} must "
                             f"have x's shape {tuple(x.shape)} on {x.device}")
    channels = x.shape[-1]
    batch_var, batch_mean = _moments(x)
    out = torch.empty_like(x)
    stats = torch.empty((4, channels), dtype=torch.float32, device=x.device)
    plan = _plan(x, out, x if residual is None else residual)
    lib = _library()
    with torch.cuda.device(x.device):
        launches = lib.deqres_bn_fwd(
            x.data_ptr(), None if residual is None else residual.data_ptr(),
            batch_mean.data_ptr(), batch_var.data_ptr(), scale.data_ptr(), offset.data_ptr(),
            mean.data_ptr(), var.data_ptr(), out.data_ptr(), stats.data_ptr(),
            x.numel() // channels, channels, plan["vec"], plan["lanes"], plan["chunks"],
            plan["chunk"], EPILOGUES.index(epilogue), epsilon, momentum, 1.0 - momentum,
            _stream(x))
    _report(x, variant("forward", epilogue),
            _raise_on_error(lib, launches, "batch norm forward"))
    return out, stats


def _launch_bwd(dy, x, stats, scale, offset=None, epilogue: str = "none"):
    """The backward's three launches on CUDA tensors: (dx, dscale,
    doffset); for ``epilogue`` "relu" dy is masked where the recomputed y
    is <= 0, which takes ``offset``."""
    if epilogue not in ("none", "relu") or (epilogue == "relu") != (offset is not None):
        raise ValueError(f"the backward's epilogue is 'none' or 'relu' (with offset); got "
                         f"{epilogue!r}, offset {offset is not None}")
    dy, scale = dy.contiguous(), scale.contiguous()
    per_channel = dict(scale=scale)
    if offset is not None:
        per_channel["offset"] = offset = offset.contiguous()
    _check(dy, **per_channel)
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must have x's shape {tuple(x.shape)}")
    channels = x.shape[-1]
    dx = torch.empty_like(x)
    dscale, doffset = (torch.empty_like(scale) for _ in range(2))
    factors = torch.empty((3, channels), dtype=torch.float32, device=x.device)
    plan = _plan(x, dy, dx)
    partial = torch.empty((plan["chunks"], channels, 2), dtype=torch.float64, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        launches = lib.deqres_bn_bwd(
            dy.data_ptr(), x.data_ptr(), stats.data_ptr(), scale.data_ptr(),
            None if offset is None else offset.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
            doffset.data_ptr(), factors.data_ptr(), partial.data_ptr(), x.numel() // channels,
            channels, plan["vec"], plan["lanes"], plan["chunks"], plan["chunk"],
            EPILOGUES.index(epilogue), _stream(x))
    _report(x, variant("backward", epilogue),
            _raise_on_error(lib, launches, "batch norm backward"))
    return dx, dscale, doffset


class FusedBatchNorm(torch.autograd.Function):
    """The kernels: the composite's forward with its epilogue and a
    closed-form backward; the graph keeps x, the forward's stats, scale and
    offset, and for "add_relu" the output, whose zeros mask the gradient."""

    @staticmethod
    def forward(ctx, x, scale, offset, mean, var, epsilon, momentum, epilogue, residual):
        out, stats = _launch(x, scale, offset, mean, var, epsilon, momentum, epilogue, residual)
        ctx.epilogue = epilogue
        ctx.save_for_backward(x, stats, scale, offset, out if epilogue == "add_relu" else None)
        ctx.mark_non_differentiable(stats)
        return out, stats

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout, _):
        x, stats, scale, offset, out = ctx.saved_tensors
        residual_grad = None
        if ctx.epilogue == "add_relu":
            dout = residual_grad = torch.ops.aten.threshold_backward(dout, out, 0)
        relu = ctx.epilogue == "relu"
        dx, dscale, doffset = _launch_bwd(dout, x, stats, scale, offset if relu else None,
                                          "relu" if relu else "none")
        return dx, dscale, doffset, None, None, None, None, None, residual_grad


def fused_batch_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    offset: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    epsilon: float,
    momentum: float,
    epilogue: str = "none",
    residual: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train-mode batch norm over the last axis of ``x`` and ``epilogue``
    (`EPILOGUES`; ``residual`` for "add_relu" only): (out, stats), stats
    (4, C) the batch mean, inv, the new running mean and the new running
    variance (not differentiable); the gradient flows to x, scale, offset
    and the residual.  `torch.var_mean` and the kernels, on CUDA tensors
    only (x and the residual contiguous float32 and the per-channel tensors
    float32 on its device, or `ValueError`), each call reported to
    `utils.tracing.STACKS`."""
    return FusedBatchNorm.apply(x, scale, offset, mean, var, float(epsilon), float(momentum),
                                epilogue, residual)
