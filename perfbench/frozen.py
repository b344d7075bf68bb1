"""Frozen copies of arithmetic the benchmark must not let the program change.

Each function copies one of the port's as it stood when the benchmark was
written (``perfbench/tests/test_frozen.py`` holds each against the port's
current one at small sizes):

- the single-block model's stage plan (`differential_equations_resnet_tpu_
  torch.models.single_block_resnet.stage_plans`);
- the nominal model FLOPs (`differential_equations_resnet_tpu_torch.utils.
  flops`), here from a configuration file's ``model`` dict;
- the H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W);
- the least time the fused kernels B1 and B2 could take
  (``chip_smoke.py::kernel_bounds``);
- the seed of a device-resident epoch's generator
  (``train/training.py::_fold_in``);
- the CIFAR augmentation on the card (``data/jit_augment.py::
  standard_cifar_augment``), which the reference replays from the epoch's
  generator.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Tuple

import torch

# NVIDIA H100 SXM, data sheet, dense rates at the 700 W limit.
PEAK_FP32_FLOPS = 67e12      # CUDA cores, no tensor cores
HBM_BYTES_PER_S = 3.35e12


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class StagePlan(NamedTuple):
    pool: bool
    has_conv_block: bool
    num_identity: int
    filters: int
    strides: Tuple[int, int]
    in_channels: int


def stage_plans(model: dict) -> Tuple[StagePlan, ...]:
    """Each stage of a single-block model: whether it opens with a strided
    or widening conv block, and how many identity blocks follow."""
    plans = []
    channels = model["filters_per_block"][0]
    for s in range(model["num_stages"] - 1):
        pool = bool(model["use_max_pooling"][s])
        filters = model["filters_per_block"][s]
        strides = tuple(model["strides"][s])
        identity_only = ((s == 0) and not pool) or (
            not pool
            and model["filters_per_block"][s] == model["filters_per_block"][s - 1]
            and strides == (1, 1)
        )
        if identity_only:
            plans.append(StagePlan(pool, False, model["blocks_per_stage"][s], channels, strides,
                                   channels))
        else:
            plans.append(StagePlan(pool, True, model["blocks_per_stage"][s] - 1, filters, strides,
                                   channels))
            channels = filters
    return tuple(plans)


def single_block_forward_flops(model: dict, batch: int) -> int:
    """Nominal forward FLOPs of a single-block ODE-ResNet, walking its stage
    plan: 2 * rows * k*k*Cin*Cout a conv (a conv block's kxk main conv and
    1x1 shortcut), the head's dense layer; elementwise work left out."""
    height, width, c_in = model["image_shape"]
    k = model["kernel_size"]
    sh, sw = model["strides"][0]
    height, width = _ceil_div(height, sh), _ceil_div(width, sw)
    channels = model["filters_per_block"][0]
    flops = 2 * batch * height * width * k * k * c_in * channels

    field_evals = {"euler": 1, "midpoint": 2, "rk4": 4}[model["integrator"]]
    for plan in stage_plans(model):
        if plan.pool:
            height, width = height // 2, width // 2
        if plan.has_conv_block:
            psh, psw = plan.strides
            height, width = _ceil_div(height, psh), _ceil_div(width, psw)
            rows = batch * height * width
            flops += 2 * rows * (k * k + 1) * plan.in_channels * plan.filters
            channels = plan.filters
        rows = batch * height * width
        flops += plan.num_identity * field_evals * 2 * rows * k * k * channels * channels
    if model["include_top"]:
        flops += 2 * batch * channels * model["num_classes"]
    return int(flops)


def identity_stacks(model: dict) -> List[Tuple[int, int, int, int]]:
    """(H, W, C, L) of each stage's identity stack of a single-block model,
    in stage order: the shapes B1 and B2 run."""
    height, width, _ = model["image_shape"]
    sh, sw = model["strides"][0]
    height, width = _ceil_div(height, sh), _ceil_div(width, sw)
    stacks = []
    for plan in stage_plans(model):
        if plan.pool:
            height, width = height // 2, width // 2
        if plan.has_conv_block:
            psh, psw = plan.strides
            height, width = _ceil_div(height, psh), _ceil_div(width, psw)
        if plan.num_identity:
            stacks.append((height, width, plan.filters, plan.num_identity))
    return stacks


def bottleneck_forward_flops(model: dict, batch: int) -> int:
    """Nominal forward FLOPs of a bottleneck ResNet: the 7x7 stem, each
    block's 1x1, 3x3 and 1x1 convs (strided as the version says), the
    projection shortcuts and the head."""
    height, width, c_in = model["image_shape"]
    height, width = (height + 6 - 7) // 2 + 1, (width + 6 - 7) // 2 + 1
    flops = 2 * batch * height * width * 49 * c_in * 64
    height, width = (height + 2 - 3) // 2 + 1, (width + 2 - 3) // 2 + 1
    channels = 64
    for stage, (blocks, (f0, f1, f2)) in enumerate(zip(model["blocks_per_stage"],
                                                      model["filters_per_block"])):
        mid = f0 if f1 is None else f1
        stride = 1 if stage == 0 else 2
        out_h, out_w = _ceil_div(height, stride), _ceil_div(width, stride)
        rows_in, rows_out = batch * height * width, batch * out_h * out_w
        flops += 2 * (rows_out if model["version"] == 1 else rows_in) * channels * f0
        flops += 2 * rows_out * (9 * f0 * mid + mid * f2 + channels * f2)
        flops += (blocks - 1) * 2 * rows_out * (f2 * f0 + 9 * f0 * mid + mid * f2)
        height, width, channels = out_h, out_w, f2
    if model["include_top"]:
        flops += 2 * batch * channels * model["num_classes"]
    return int(flops)


def forward_flops(family: str, model: dict, batch: int) -> int:
    if family == "bottleneck":
        return bottleneck_forward_flops(model, batch)
    return single_block_forward_flops(model, batch)


def train_flops(family: str, model: dict, batch: int) -> int:
    """A train step's nominal FLOPs: three times the forward."""
    return 3 * forward_flops(family, model, batch)


def kernel_bounds(b: int, hh: int, ww: int, c: int, layers: int, backward: bool = False) -> dict:
    """The least time B1 (or B2) could take at this shape: FLOPs over the
    fp32 CUDA-core rate against the bytes that each input read once and
    each output written once move over HBM.  B1: 2*L*B*H*W*9C^2 FLOPs, x,
    K and b in, y out.  B2: the forward recompute, dK and the state
    cotangent, each 2*L*B*H*W*9C^2; x, g, K and b in, gx, gK and gb out."""
    passes = 3 if backward else 1
    flops = passes * 2 * layers * b * hh * ww * 9 * c * c
    state, kernels, biases = b * hh * ww * c, layers * 9 * c * c, layers * c
    nbytes = 4 * ((3 * state + 2 * kernels + 2 * biases) if backward
                  else (2 * state + kernels + biases))
    flop_ms = flops / PEAK_FP32_FLOPS * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(flops=flops, nbytes=nbytes, flop_ms=flop_ms, byte_ms=byte_ms,
                bound_ms=max(flop_ms, byte_ms),
                bound_by="operations" if flop_ms >= byte_ms else "bytes")


def fold_in(seed: int, step: int) -> int:
    """The seed of the generator of the device-resident epoch that starts at
    global step ``step``."""
    return (int(seed) * 0x9E3779B97F4A7C15 + int(step)) % (2 ** 63)


Augment = Callable[[torch.Generator, torch.Tensor], torch.Tensor]


def _crop(images: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor,
          height: int, width: int) -> torch.Tensor:
    n = images.shape[0]
    rows = tops[:, None] + torch.arange(height, device=images.device)
    cols = lefts[:, None] + torch.arange(width, device=images.device)
    batch = torch.arange(n, device=images.device)[:, None, None]
    return images[batch, rows[:, :, None], cols[:, None, :]]


def pad_random_crop(generator: torch.Generator, images: torch.Tensor, padding: int) -> torch.Tensor:
    """Zero-pad by ``padding``, crop back at a per-image uniform offset: the
    tops, then the lefts, drawn from ``generator``."""
    n, h, w = images.shape[:3]
    tops = torch.randint(0, 2 * padding + 1, (n,), generator=generator, device=images.device)
    lefts = torch.randint(0, 2 * padding + 1, (n,), generator=generator, device=images.device)
    padded = torch.nn.functional.pad(images, (0, 0, padding, padding, padding, padding))
    return _crop(padded, tops, lefts, h, w)


def random_flip(generator: torch.Generator, images: torch.Tensor) -> torch.Tensor:
    """Mirror each image with probability 1/2."""
    flip = torch.rand(images.shape[0], generator=generator, device=images.device) < 0.5
    return torch.where(flip[:, None, None, None], images.flip(2), images)


def cifar_augment(crop_padding: int = 4, flip: bool = True) -> Augment:
    """The crop, then the flip, each drawing from the same generator in
    turn (no brightness)."""
    fns: List[Augment] = []
    if crop_padding:
        fns.append(lambda g, x: pad_random_crop(g, x, crop_padding))
    if flip:
        fns.append(random_flip)

    def apply(generator: torch.Generator, images: torch.Tensor) -> torch.Tensor:
        for fn in fns:
            images = fn(generator, images)
        return images

    return apply
