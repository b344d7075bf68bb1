"""Analytic FLOP accounting for model TFLOP/s and MFU.

Port of `differential_equations_resnet_tpu/utils/flops.py`.  It counts MODEL
FLOPs, the nominal dense-conv arithmetic (2 * rows * k*k*Cin*Cout a
convolution), not what an implementation executes.  MFU = model FLOPs /
wall time / the card's peak.

The peaks are an NVIDIA H100 SXM's (NVIDIA's data sheet, dense, at its 700 W
limit).  MFU is taken against the peak of the dtype a model computes in
(`peak_of`): fp32 outside the tensor cores, or bf16 (and fp16) on them.
`mfu` defaults to the fp32 peak.
"""

from __future__ import annotations

from typing import Any

from differential_equations_resnet_tpu_torch.models.single_block_resnet import stage_plans


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def single_block_forward_flops(config: Any, batch_size: int) -> int:
    """Nominal forward-pass FLOPs of a single-block ODE-ResNet, walking the
    model's own stage plan.  Elementwise work (bias, relu, residual add,
    pooling, normalization) is left out: it is O(rows*C) against the convs'
    O(rows*k^2*C^2)."""
    height, width, c_in = config.image_shape
    k = config.kernel_size
    sh, sw = config.strides[0]
    height, width = _ceil_div(height, sh), _ceil_div(width, sw)
    channels = config.filters_per_block[0]
    flops = 2 * batch_size * height * width * k * k * c_in * channels

    field_evals = {"euler": 1, "midpoint": 2, "rk4": 4}[config.integrator]
    for plan in stage_plans(config):
        if plan.pool:
            height, width = height // 2, width // 2
        if plan.has_conv_block:
            psh, psw = plan.strides
            height, width = _ceil_div(height, psh), _ceil_div(width, psw)
            rows = batch_size * height * width
            # The main kxk conv and the 1x1 shortcut.
            flops += 2 * rows * (k * k + 1) * plan.in_channels * plan.filters
            channels = plan.filters
        rows = batch_size * height * width
        flops += plan.num_identity * field_evals * 2 * rows * k * k * channels * channels
    if config.include_top:
        flops += 2 * batch_size * channels * config.num_classes
    return int(flops)


def single_block_train_flops(config: Any, batch_size: int) -> int:
    """Nominal train-step FLOPs: forward and backward, the backward about
    twice the forward (one cotangent conv and one filter-gradient
    contraction a kernel)."""
    return 3 * single_block_forward_flops(config, batch_size)


def bottleneck_forward_flops(config: Any, batch_size: int) -> int:
    """Nominal forward-pass FLOPs of a bottleneck ResNet: the stem's 7x7
    conv, each block's 1x1, 3x3 and 1x1 convs (strided as the version
    says), the projection shortcuts and the head.  Batch norm, relu, the
    adds and the pools are left out, as in `single_block_forward_flops`.
    The JAX package counts none for this family; this count is the port's."""
    height, width, c_in = config.image_shape
    height, width = (height + 6 - 7) // 2 + 1, (width + 6 - 7) // 2 + 1  # pad 3, 7x7/2 VALID
    flops = 2 * batch_size * height * width * 49 * c_in * 64
    height, width = (height + 2 - 3) // 2 + 1, (width + 2 - 3) // 2 + 1  # pad 1, 3x3/2 pool
    channels = 64
    for stage, (blocks, (f0, f1, f2)) in enumerate(zip(config.blocks_per_stage,
                                                      config.filters_per_block)):
        mid = f0 if f1 is None else f1
        stride = 1 if stage == 0 else 2
        out_h, out_w = _ceil_div(height, stride), _ceil_div(width, stride)
        rows_in, rows_out = batch_size * height * width, batch_size * out_h * out_w
        # The first 1x1 conv runs at the input's rows in v1.5, the output's in v1.
        flops += 2 * (rows_out if config.version == 1 else rows_in) * channels * f0
        flops += 2 * rows_out * (9 * f0 * mid + mid * f2 + channels * f2)
        flops += (blocks - 1) * 2 * rows_out * (f2 * f0 + 9 * f0 * mid + mid * f2)
        height, width, channels = out_h, out_w, f2
    if config.include_top:
        flops += 2 * batch_size * channels * config.num_classes
    return int(flops)


def train_flops(config: Any, batch_size: int) -> int:
    """Nominal train-step FLOPs of either family: three times the forward."""
    if hasattr(config, "version"):
        return 3 * bottleneck_forward_flops(config, batch_size)
    return single_block_train_flops(config, batch_size)


# Peak rates of one NVIDIA H100 SXM (data sheet, dense, 700 W), in FLOP/s.
PEAK_FLOPS = {
    "h100_sxm_fp32": 67e12,     # CUDA cores, no tensor cores
    "h100_sxm_tf32": 495e12,
    "h100_sxm_bf16": 989e12,
    "h100_sxm_fp8": 1979e12,
    "h100_sxm_int8": 1979e12,   # int8 x int8 -> int32 ops/s on the tensor cores
}


# The peak of each compute dtype, by its name: (PEAK_FLOPS key, FLOP/s).
_PEAK_OF_DTYPE = {"float32": "h100_sxm_fp32", "bfloat16": "h100_sxm_bf16",
                  "float16": "h100_sxm_bf16"}


def peak_of(dtype) -> tuple:
    """(name, FLOP/s) of the peak that MFU is taken against for a model
    computing in ``dtype`` (a torch dtype or its name): "fp32" or "bf16"
    (fp16 runs at the bf16 rate)."""
    key = _PEAK_OF_DTYPE[str(dtype).replace("torch.", "")]
    return key.rsplit("_", 1)[1], PEAK_FLOPS[key]


def mfu(flops_per_step: float, steps_per_sec: float,
        peak: float = PEAK_FLOPS["h100_sxm_fp32"]) -> float:
    """Model-FLOPs utilization: achieved model FLOP/s over the peak."""
    return flops_per_step * steps_per_sec / peak
