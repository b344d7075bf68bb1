"""Quantized (dynamic w8a8 int8) serving of both model families, in PyTorch.

Port of `differential_equations_resnet_tpu/models/quantized.py`.  The convs
where the FLOPs are run int8 x int8 -> int32 (`ops.quantize`) with static
per-output-channel weight scales, quantized once, and dynamic per-tensor
activation scales; the stem, the single-block family's conv blocks and the
head stay in the compute dtype.

Which convs are quantized is part of the function served, so the gates are
the JAX package's defaults, although they were chosen from measurements on
a TPU: a single-block stage's identity trunk is int8 when it is at least
``min_channels`` = 128 wide, a bottleneck stage when its mid width is at
least `BOTTLENECK_MIN_MID_CHANNELS` = 256 (main-path convs and projection
shortcut, strided ones included).  Narrower stages take the model's own
forward: on the card a narrow single-block Euler trunk runs on B1.

The activation scales are per tensor over the whole batch, so an image's
output depends on the batch it is served in, as in the JAX package.
`QuantizedForward` (and `make_quantized_forward`, its serving function)
quantizes the weights once; `apply_quantized` (and the per-family
functions) are the pure forward, quantizing on each call, as the JAX
functions are.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch import nn

from differential_equations_resnet_tpu_torch.models import bottleneck_resnet as bottleneck
from differential_equations_resnet_tpu_torch.models.blocks import batch_norm, max_pool_2x2
from differential_equations_resnet_tpu_torch.models.single_block_resnet import (
    SingleBlockResNetConfig,
    _apply_conv_block,
    _apply_identity_blocks,
    _dense_blocks,
    _named_leaves,
    _stem,
    head,
    map_leaves,
    stage_plans,
)
from differential_equations_resnet_tpu_torch.ops.conv import conv2d_same
from differential_equations_resnet_tpu_torch.ops.integrators import (
    get_integrator,
    layer_slice,
    num_layers,
)
from differential_equations_resnet_tpu_torch.ops.quantize import (
    QuantizedConvParams,
    dynamic_int8_conv_same,
    quantize_kernel_per_cout,
)

MIN_CHANNELS = 128
BOTTLENECK_MIN_MID_CHANNELS = 256


def _apply_identity_blocks_int8(x, qp: QuantizedConvParams, sp, ss, config):
    """A stage's identity stack with dynamic w8a8 convs: the integrator
    over ``relu(int8conv(y))`` layer by layer, the stacked per-c_out
    quantized kernels ``qp`` sliced per layer; with batch norm (Euler only)
    conv -> batch norm on the running statistics -> relu -> h* -> add."""
    h = config.h
    if not config.use_batch_norm:
        step = get_integrator(config.integrator)
        field = lambda y, p: torch.relu(dynamic_int8_conv_same(y, p))
        for layer in range(num_layers(qp)):
            x = step(field, x, h, layer_slice(qp, layer))
        return x
    for layer in range(num_layers(qp)):
        z = dynamic_int8_conv_same(x, layer_slice(qp, layer))
        z, _ = batch_norm(z, layer_slice(sp["blocks_bn"], layer),
                          layer_slice(ss["blocks_bn"], layer), False)
        x = x + h * torch.relu(z)
    return x


def _check_single_device(config) -> None:
    if getattr(config, "tp_mesh", None) is not None or getattr(config, "pp_mesh", None) is not None:
        raise ValueError(
            "quantized inference is a single-device serving path; build the "
            "model without tp_mesh/pp_mesh (shard the batch outside instead)."
        )


def quantize_single_block(params: dict, config: SingleBlockResNetConfig,
                          min_channels: int = MIN_CHANNELS) -> list:
    """Per stage, the identity stack's per-c_out quantized kernels
    (stacked (L, ...)) where the stage is at least ``min_channels`` wide,
    else None."""
    return [quantize_kernel_per_cout(*_dense_blocks(sp["blocks"], config))
            if sp["blocks"] is not None and plan.filters >= min_channels else None
            for plan, sp in zip(stage_plans(config), params["stages"])]


def _single_block_forward(params, quantized, state, x, config, return_logits):
    _check_single_device(config)
    x = _stem(params, state, x, config, False, {})
    for plan, sp, ss, qp in zip(stage_plans(config), params["stages"], state["stages"],
                                quantized):
        if plan.pool:
            x = max_pool_2x2(x)
        if plan.has_conv_block:
            x, _ = _apply_conv_block(x, sp, ss, config, plan.strides, False)
        if qp is not None:
            x = _apply_identity_blocks_int8(x, qp, sp, ss, config)
        elif sp["blocks"] is not None:
            x, _ = _apply_identity_blocks(x, sp, ss, config, False)
    return head(params, x, config, return_logits)


def apply_single_block_resnet_quantized(params, state, x: torch.Tensor,
                                        config: SingleBlockResNetConfig,
                                        min_channels: int = MIN_CHANNELS,
                                        return_logits: bool = False) -> torch.Tensor:
    """The inference forward (``apply(train=False)``) with int8 identity
    trunks in the stages at least ``min_channels`` wide; the others take
    the model's own path.  Returns the output only: the state (batch norm's
    running statistics) is read, never updated."""
    return _single_block_forward(params, quantize_single_block(params, config, min_channels),
                                 state, x, config, return_logits)


def _q_block_params(p: dict, mid_kernel: torch.Tensor) -> dict:
    """One bottleneck block's three conv weights (or a stack of blocks',
    leading axes kept) quantized per c_out, the mid-conv from its dense
    ``mid_kernel``; the batch-norm parameters pass through."""
    q = {
        "conv1": quantize_kernel_per_cout(p["conv1"].kernel, p["conv1"].bias),
        "conv2": quantize_kernel_per_cout(mid_kernel, p["conv2"].bias),
        "conv3": quantize_kernel_per_cout(p["conv3"].kernel, p["conv3"].bias),
    }
    q.update({name: p[name] for name in ("bn1", "bn2", "bn3") if name in p})
    return q


def _apply_bottleneck_main_int8(x, qp: dict, s: dict, config, strides):
    """`bottleneck_resnet._apply_bottleneck_main` with pre-quantized w8a8
    convs (strided ones included) and batch norm on the running
    statistics."""
    if config.version == 1:
        strides_1x1, strides_3x3 = strides, (1, 1)
    else:
        strides_1x1, strides_3x3 = (1, 1), strides
    bn = config.use_batch_norm
    y = dynamic_int8_conv_same(x, qp["conv1"], strides_1x1)
    if bn:
        y, _ = batch_norm(y, qp["bn1"], s["bn1"], False)
    y = dynamic_int8_conv_same(torch.relu(y), qp["conv2"], strides_3x3)
    if bn:
        y, _ = batch_norm(y, qp["bn2"], s["bn2"], False)
    y = dynamic_int8_conv_same(torch.relu(y), qp["conv3"])
    if bn:
        y, _ = batch_norm(y, qp["bn3"], s["bn3"], False)
    return y


def quantize_resnet(params: dict, config,
                    min_mid_channels: int = BOTTLENECK_MIN_MID_CHANNELS) -> list:
    """Per stage, its quantized convs ({"conv_block", "shortcut",
    "identity_blocks"}) where the stage's mid width is at least
    ``min_mid_channels``, else None."""
    stages = []
    for sp, filters in zip(params["stages"], config.filters_per_block):
        if bottleneck._mid_width(config, filters) < min_mid_channels:
            stages.append(None)
            continue
        block = sp["conv_block"]
        blocks = sp["identity_blocks"]
        stages.append({
            "conv_block": _q_block_params(block, bottleneck.mid_kernel(block["conv2"],
                                                                       config.gamma)),
            "shortcut": quantize_kernel_per_cout(sp["shortcut"].kernel, sp["shortcut"].bias),
            "identity_blocks": None if blocks is None else _q_block_params(
                blocks, bottleneck.mid_kernel(blocks["conv2"], config.gamma)),
        })
    return stages


def _resnet_forward(params, quantized, state, x, config, return_logits):
    bn = config.use_batch_norm
    x = bottleneck._stem(params, state, x, config, False, {})
    for stage, (sp, ss, qs) in enumerate(zip(params["stages"], state["stages"], quantized)):
        strides = (1, 1) if stage == 0 else (2, 2)
        if qs is not None:
            main = _apply_bottleneck_main_int8(x, qs["conv_block"], ss["conv_block"], config,
                                               strides)
            shortcut = dynamic_int8_conv_same(x, qs["shortcut"], strides)
        else:
            main, _ = bottleneck._apply_bottleneck_main(
                x, sp["conv_block"], ss["conv_block"],
                bottleneck.mid_kernel(sp["conv_block"]["conv2"], config.gamma),
                config, strides, False)
            shortcut = conv2d_same(x, sp["shortcut"].kernel, strides=strides,
                                   bias=sp["shortcut"].bias)
        if bn:
            shortcut, _ = batch_norm(shortcut, sp["bn_shortcut"], ss["bn_shortcut"], False)
        x = torch.relu(main + shortcut)
        blocks = sp["identity_blocks"]
        if blocks is None:
            continue
        kernels = None if qs is not None else bottleneck.mid_kernel(blocks["conv2"], config.gamma)
        for layer in range(num_layers(blocks)):
            s = layer_slice(ss["identity_blocks"], layer)
            if qs is not None:
                main = _apply_bottleneck_main_int8(
                    x, layer_slice(qs["identity_blocks"], layer), s, config, (1, 1))
            else:
                main, _ = bottleneck._apply_bottleneck_main(
                    x, layer_slice(blocks, layer), s, kernels[layer], config, (1, 1), False)
            x = torch.relu(main + x)
    return head(params, x, config, return_logits)


def apply_resnet_quantized(params, state, x: torch.Tensor, config,
                           min_mid_channels: int = BOTTLENECK_MIN_MID_CHANNELS,
                           return_logits: bool = False) -> torch.Tensor:
    """Bottleneck-family inference with w8a8 blocks in the stages whose mid
    width is at least ``min_mid_channels``; the stem and narrower stages in
    the compute dtype.  Mirrors ``apply_resnet(train=False)``."""
    return _resnet_forward(params, quantize_resnet(params, config, min_mid_channels),
                           state, x, config, return_logits)


def apply_quantized(params, state, x: torch.Tensor, config,
                    return_logits: bool = False) -> torch.Tensor:
    """Family dispatch: the quantized forward of either family with its
    default gate."""
    if isinstance(config, SingleBlockResNetConfig):
        return apply_single_block_resnet_quantized(params, state, x, config,
                                                   return_logits=return_logits)
    return apply_resnet_quantized(params, state, x, config, return_logits=return_logits)


class QuantizedForward(nn.Module):
    """``module(images) -> output``: ``model`` (either family) served with
    int8 convs, its weights quantized once here.  Every tensor it reads
    (the parameters, the quantized weights and scales, the running
    statistics) is one of its buffers, so `torch.export` traces it into a
    program that carries them (`utils.serving.export_model`).  ``params``
    and ``model_state`` default to the model's own; ``min_channels``
    overrides the family's gate (trunk width 128 for the single-block
    family, mid width 256 for the bottleneck one)."""

    def __init__(self, model, params: Optional[dict] = None, model_state: Any = None,
                 min_channels: Optional[int] = None, return_logits: bool = False):
        super().__init__()
        config = self.config = model.config
        params = model.params() if params is None else params
        state = model.state() if model_state is None else model_state
        with torch.no_grad():
            if isinstance(config, SingleBlockResNetConfig):
                quantized = quantize_single_block(
                    params, config, MIN_CHANNELS if min_channels is None else min_channels)
                self._apply = _single_block_forward
            else:
                quantized = quantize_resnet(
                    params, config,
                    BOTTLENECK_MIN_MID_CHANNELS if min_channels is None else min_channels)
                self._apply = _resnet_forward
        self._trees = (params, quantized, state)
        self._names = []
        for name, leaf in _named_leaves(self._trees):
            self.register_buffer(name, leaf.detach())
            self._names.append(name)
        self.return_logits = return_logits

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        leaves = iter([self._buffers[name] for name in self._names])
        params, quantized, state = map_leaves(lambda _: next(leaves), self._trees)
        return self._apply(params, quantized, state, x, self.config, self.return_logits)


def make_quantized_forward(
    model,
    params: Optional[dict] = None,
    model_state: Any = None,
    min_channels: Optional[int] = None,
    return_logits: bool = False,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``fn(images) -> output`` serving ``model`` (either family) with int8
    convs, its weights quantized once here (`QuantizedForward`).  ``fn``
    runs in inference mode."""
    module = QuantizedForward(model, params, model_state, min_channels, return_logits)

    def fn(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return module(x)

    return fn
